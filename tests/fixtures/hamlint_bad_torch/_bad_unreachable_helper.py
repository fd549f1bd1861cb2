"""hamlint fixture helper: defines a handler function that a DIFFERENT
module registers at import time (the PR 2 divergence class).  Never
imported — parsed by the linter only."""


def helper_handler(a, b):
    return a * b
