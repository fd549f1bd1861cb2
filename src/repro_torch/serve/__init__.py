"""Serving of the port: the continuous-batching engines (``engine``), the
cluster-serving control handlers (``handlers``) and the worker-resident
decode loop (``stream``)."""
