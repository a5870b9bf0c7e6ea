"""dispatch_ms.scm_eval: host ms of one call of the program's step (the
"dispatch" span), which returns before the card has finished it."""

from perfbench.core.readers import span_ms


def read(record):
    return span_ms(record, "dispatch")
