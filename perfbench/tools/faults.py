"""Faults planted under the timed path, for the fault test and for the
fault readings that bound a training cell's limits:

  unchanged_state  the optimizer's step returns the state unchanged;
  half_batch       the loss is the mean over the first half of the
                   batch's rows, the other half left out;
  altered_answer   one answer (the first pair's count) is moved by a
                   tenth of the batch's largest, where the model
                   produces it.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from dualmessagepassing_tpu_torch.train import scm_driver
from dualmessagepassing_tpu_torch.unc import driver as unc_driver
from dualmessagepassing_tpu_torch.unc.model import UNCTrainModel


def _noop(self, *args, **kwargs):
    return None


def _unc_half(orig):
    def loss(self, embedding, edge_type, edge_mask, samples, labels,
             sample_mask, node_mask=None):
        n = int(sample_mask.sum())
        keep = torch.arange(sample_mask.shape[0],
                            device=sample_mask.device) < n // 2
        return orig(self, embedding, edge_type, edge_mask, samples, labels,
                    sample_mask & keep, node_mask)
    return loss


def _scm_half(orig):
    def loss(output, counts, node_weights, edge_weights, **kw):
        b = counts.shape[0]
        h = b // 2

        def cut(x):
            return x[:h] if torch.is_tensor(x) and x.dim() and \
                x.shape[0] == b else x
        return orig({k: cut(v) for k, v in output.items()}, counts[:h],
                    cut(node_weights), cut(edge_weights), **kw)
    return loss


def _altered(orig):
    def apply(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        pred_c = out["pred_c"].clone()
        pred_c[0] += 0.1 * pred_c.abs().max() + 1.0
        out["pred_c"] = pred_c
        return out
    return apply


@contextlib.contextmanager
def planted(loop: str, fault: str):
    """The program with `fault` planted, for a cell of loop `loop`."""
    if fault == "unchanged_state" and loop == "unc_train":
        patch = mock.patch.object(unc_driver.UNCOptimizer, "step", _noop)
    elif fault == "unchanged_state" and loop == "scm_train":
        patch = mock.patch.object(scm_driver.SCMOptimizer, "step", _noop)
    elif fault == "half_batch" and loop == "unc_train":
        patch = mock.patch.object(
            UNCTrainModel, "unsupervised_loss",
            _unc_half(UNCTrainModel.unsupervised_loss))
    elif fault == "half_batch" and loop == "scm_train":
        patch = mock.patch.object(scm_driver, "scm_loss",
                                  _scm_half(scm_driver.scm_loss))
    elif fault == "altered_answer" and loop == "scm_eval":
        patch = mock.patch.object(scm_driver, "apply_model",
                                  _altered(scm_driver.apply_model))
    else:
        raise ValueError(f"no fault {fault!r} for loop {loop!r}")
    with patch:
        yield
