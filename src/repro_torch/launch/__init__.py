"""Launchers: ``python -m repro_torch.launch.train`` (the counterpart of
``repro/launch``; the dry-run and HLO analysis wait for the sharding work)."""
