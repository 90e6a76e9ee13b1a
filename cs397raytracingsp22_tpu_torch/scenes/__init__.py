"""Scene scripts for the port: each exposes `build(**overrides) -> Scene`."""
