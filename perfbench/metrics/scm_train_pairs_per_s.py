"""scm_train_pairs_per_s: the pairs of every step completed in the window over the
window's host seconds, with the profiler off: the rate a user of this
machine feels, paced by whichever of the host and the card is slower."""

from perfbench.core.readers import host_rate


def read(record):
    return host_rate(record, "pairs")
