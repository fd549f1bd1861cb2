"""HAM core of the port.

Kept light on purpose: importing ``repro_torch.core`` loads no model or
kernel module.  Import :mod:`repro_torch.core.device_table` and
:mod:`repro_torch.core.errors` directly.
"""
