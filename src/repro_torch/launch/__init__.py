"""Launchers: command-line entry points over the port's apps
(``python -m repro_torch.launch.serve_queries``) and models
(``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``)."""
