"""Logging with machine-parseable "best" lines (a copy of
dualmessagepassing_tpu/utils/log.py; reference SubgraphCountingMatching/
utils/log.py:1-76).

Checkpoint selection parses the log with a regex (get_best_epochs), so
every line format is the JAX package's character for character: each
package finds the best epoch in a log the other wrote.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict


def init_logger(log_file=None, log_tag="GOOD LUCK") -> logging.Logger:
    logger = logging.getLogger("dualmessagepassing_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(f"[%(asctime)s {log_tag}] %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger):
    for h in logger.handlers[:]:
        h.close()
        logger.removeHandler(h)


def generate_log_line(data_type, epoch=-1, total_epochs=-1, step=-1,
                      total_steps=-1, **kw) -> str:
    line = ["data_type: {:<10s}".format(data_type)]
    if epoch != -1 and total_epochs != -1:
        line.append("epoch: {:0>5d}/{:0>5d}".format(epoch, total_epochs))
    if step != -1 and total_steps != -1:
        line.append("step: {:0>5d}/{:0>5d}".format(step, total_steps))
    for k, v in kw.items():
        if isinstance(v, float):
            line.append("{}: {:8>5.3f}".format(k, v))
        elif isinstance(v, int):
            line.append("{}: {:0>3d}".format(k, v))
        else:
            line.append("{}: {}".format(k, v))
    return "\t".join(line)


def generate_best_line(data_type, epoch, total_epochs, **kw) -> str:
    line = (["data_type: " + str(data_type)]
            + ["best %s: %s" % (str(k), str(v)) for k, v in kw.items()]
            + ["(epoch: %d/%d)" % (epoch, total_epochs)])
    return "\t".join(line)


_BEST_RE = re.compile(
    r"data_type:\s+(\w+)\s+best\s+([a-zA-Z0-9\.\-\+\_]+):\s+"
    r"([a-zA-Z0-9\.\-\+\_]+)\s+\(epoch:\s+(\d+)/\d+\)"
)


def get_best_epochs(log_file: str) -> Dict[str, Dict[str, tuple]]:
    """metric -> data_type -> (epoch, value) (log.py:59-76)."""
    best: Dict[str, Dict[str, tuple]] = {}
    with open(log_file) as f:
        for line in f:
            for m in _BEST_RE.findall(line):
                best.setdefault(m[1], {})[m[0]] = (int(m[3]), float(m[2]))
    return best
