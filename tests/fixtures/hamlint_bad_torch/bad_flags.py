"""hamlint fixture: wire constants declared outside the centralized
registry, one colliding with a live bit and one sentinel inside live msg_id
space.  Never imported — parsed by the linter only."""

# collides with FLAG_STATIC (bit 3) in repro_torch.core.flags
FLAG_EXPERIMENTAL = 1 << 3

# a "reserved" msg_id sentinel low enough for live traffic to reach
MSG_ID_DRAIN = 1 << 20
