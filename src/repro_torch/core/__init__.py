"""HAM core of the port.

Kept light on purpose: importing ``repro_torch.core`` loads no model or
kernel module.  Import its modules directly: ``errors``, ``device_table``,
``dtensor`` (DTensor helpers) and the wire layer (``flags``, ``message``,
``migratable``, ``wireplan``, ``registry``, ``closure``, ``future``,
``executor``).
"""
