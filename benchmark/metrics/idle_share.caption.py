"""% of a caption batch's wall in which the card ran no kernel, copy or
memset: device busy time per traced batch over the median wall of the
window's unprofiled batches (``readers.idle_share``)."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
