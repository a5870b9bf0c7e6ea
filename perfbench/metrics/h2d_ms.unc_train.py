"""h2d_ms.unc_train: host ms of the program's to_device of one prepared
batch (the "to_device" span): its pageable host-to-device copies."""

from perfbench.core.readers import span_ms


def read(record):
    return span_ms(record, "to_device")
