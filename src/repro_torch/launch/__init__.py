"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``) and the production mesh (``mesh``)."""
