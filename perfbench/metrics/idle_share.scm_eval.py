"""idle_share.scm_eval: the share of the traced window in which the card ran
no kernel, memset or copy: 1 - (union of device intervals) / window."""

from perfbench.core.readers import idle_share


def read(record):
    return idle_share(record)
