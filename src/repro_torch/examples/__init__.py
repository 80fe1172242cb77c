"""The reference's examples on the port, run as
``python -m repro_torch.examples.<name>``:

* :mod:`.approx_inference` — approximate-arithmetic inference screening,
  ad hoc or from a persisted operator library under a QoS budget;
* :mod:`.serve_batch` — the serve launcher on a reduced model;
* :mod:`.train_small` — a small model trained from scratch;
* :mod:`.quickstart` — the paper's pipeline on one benchmark, without
  the steps that need z3.

Each runs on the card unless given ``--device cpu``; the quickstart's
steps are host numpy and use no device.
"""
