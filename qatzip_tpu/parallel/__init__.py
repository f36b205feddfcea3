"""Distributed layer: block-data-parallel sharding over device meshes."""
