"""CompGCN's composition operator (dualmessagepassing_tpu/models/
compgcn.py:36-49; reference SubgraphCountingMatching/models/
compgcn.py:84-98, 213-224). The UNC CompGraphConv (unc/model.py) reads
it; the SCM CompGCN layer of that module is not ported yet.
"""

from __future__ import annotations

import torch


def comp_func(head: torch.Tensor, relation: torch.Tensor,
              comp_opt: str) -> torch.Tensor:
    """head (-) relation: "sub" head - relation, "mult" head * relation,
    "corr" the circular correlation irfft(conj(rfft(head)) * rfft(rel)),
    out[k] = sum_i head[i] * relation[(i + k) mod n], over the last axis.
    The correlation runs in float32 and returns head's dtype, as the JAX
    package's does under bf16 compute."""
    if comp_opt == "sub":
        return head - relation
    if comp_opt == "mult":
        return head * relation
    if comp_opt == "corr":
        n = head.shape[-1]
        fh = torch.fft.rfft(head.float(), dim=-1)
        fr = torch.fft.rfft(relation.float(), dim=-1)
        out = torch.fft.irfft(torch.conj(fh) * fr, n=n, dim=-1)
        return out.to(head.dtype)
    raise NotImplementedError(f"comp_opt {comp_opt}")
