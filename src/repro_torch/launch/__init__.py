"""Launchers (the counterpart of ``repro/launch``): ``python -m
repro_torch.launch.train`` runs a training loop; ``python -m
repro_torch.launch.dryrun`` counts every (architecture x shape) cell's step
on the ``meta`` device (``op_analysis``: FLOPs and bytes of the ops it
dispatches) into the reference's cell JSON, on the production meshes that
``mesh`` describes.  The sharding layer that maps those meshes onto devices
is not ported yet."""
