"""Training loop, train steps and fault tolerance (port of ``repro.train``)."""
