"""Work counts of the sweeps, one module per sweep kind (the ``sweep.cost``
of a configuration file names it): ``work(config, state)`` returns the
(bytes, flop) one sweep of the whole problem must move and compute,
counted from the problem's shapes, whatever implements the sweep."""
