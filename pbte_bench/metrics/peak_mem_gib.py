"""The device memory the window needs: ``torch.cuda.max_memory_allocated``
over the window, reset at its start, in GiB."""


def read(run):
    b = run.results.get("window_peak_bytes")
    return None if b is None else b / 2**30
