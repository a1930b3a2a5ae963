"""The engine's own count of host reads of the device
(``last_stats["host_syncs"]``) over the levels of the window's checks
that the window did not stop."""

from tlcbench.metrics._share import host_syncs_per_level


def read(ctx):
    return host_syncs_per_level(ctx)
