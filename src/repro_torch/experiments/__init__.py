"""The reference's experiments on the port, run as
``python -m repro_torch.experiments.<name>``:

* :mod:`.hillclimb` — the dry-run's hill-climb over the ``train_4k`` cells
  of three models, winners picked by Pareto dominance.

Each runs on the host, with no card (the dry-run's fake world).
"""
