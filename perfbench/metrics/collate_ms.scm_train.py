"""collate_ms.scm_train: host ms of the dataset's batchify of one batch
(the "collate" span), as train_epoch calls it."""

from perfbench.core.readers import span_ms


def read(record):
    return span_ms(record, "collate")
