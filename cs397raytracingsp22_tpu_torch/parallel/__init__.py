"""Multi-device and multi-host rendering on torch.distributed: pixels over
the mesh's "dp" axis, samples over "sp" (sharding.py), process-group set-up
and checkpoint broadcast (multihost.py)."""
