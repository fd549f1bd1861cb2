"""Sharding plans, meshes and the dry-run on the H100 roofline (port of
``repro.launch``)."""
