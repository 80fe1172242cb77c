"""Entry points of the port: the serve launcher (``python -m
repro_torch.launch.serve``) and the reports it prints
(:mod:`.analysis`)."""
