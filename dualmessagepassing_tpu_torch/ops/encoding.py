"""Host-side integer encodings: a numpy copy of
dualmessagepassing_tpu/ops/encoding.py:20-96 (get_enc_len, int2anybase,
int2multihot, multihot_table, position_table), which the JAX package's
__init__ keeps out of reach on a machine without jax. The arrays equal the JAX
package's (tests/test_torch_unc_backbones.py).

Reference: SubgraphCountingMatching/models/embed.py:8-101 (numba kernels).
  * get_enc_len(x, base)     — number of base-`base` digits of x (min 1);
  * int2multihot(x, l, base) — l blocks of size `base`, most-significant
    digit first, leading blocks one-hot at digit 0, x taken mod base**l.
"""

from __future__ import annotations

import numpy as np


def get_enc_len(x, base: int = 10):
    """Digit count of x in base `base` (elementwise; min 1)."""
    scalar = np.isscalar(x)
    n = np.abs(np.atleast_1d(np.asarray(x, dtype=np.int64)))
    cnt = np.zeros_like(n)
    while (n > 0).any():
        cnt[n > 0] += 1
        n = n // base
    out = np.maximum(cnt, 1)
    return int(out[0]) if scalar else out.reshape(np.shape(x))


def int2anybase(x, len_x: int, base: int = 10) -> np.ndarray:
    """Base-`base` digits of x (most-significant first), shape [..., len_x]."""
    scalar = np.isscalar(x)
    arr = np.atleast_1d(np.asarray(x, dtype=np.int64)).reshape(-1)
    arr = arr % (base ** len_x)
    digits = np.zeros((arr.shape[0], len_x), dtype=np.int64)
    for pos in range(len_x - 1, -1, -1):
        digits[:, pos] = arr % base
        arr = arr // base
    if scalar:
        return digits[0]
    return digits.reshape(np.shape(x) + (len_x,))


def int2multihot(x, len_x: int, base: int = 10) -> np.ndarray:
    """Multi-hot digit encoding, shape [..., len_x * base]: block k is the
    one-hot of digit k (most-significant first)."""
    flat = int2anybase(x, len_x, base).reshape(-1, len_x)
    n = flat.shape[0]
    rep = np.zeros((n, len_x, base), dtype=np.int64)
    rep[np.repeat(np.arange(n), len_x), np.tile(np.arange(len_x), n),
        flat.reshape(-1)] = 1
    rep = rep.reshape(n, len_x * base)
    if np.isscalar(x):
        return rep[0]
    return rep.reshape(np.shape(x) + (len_x * base,))


def multihot_table(max_n: int, base: int = 2) -> np.ndarray:
    """Frozen [max_n, enc_len * base] float32 table: rows are
    int2multihot(0..max_n-1) with enc_len = get_enc_len(max_n - 1, base)
    (MultihotEmbedding.__init__, embed.py:197-208)."""
    enc_len = get_enc_len(max_n - 1, base)
    return int2multihot(np.arange(max_n), enc_len, base).astype(np.float32)


def position_table(embedding_dim: int, max_len: int = 512,
                   scale: float = 1.0) -> np.ndarray:
    """Frozen sinusoidal table [max_len, embedding_dim]
    (PositionEmbedding.__init__, embed.py:211-222): inv_freq =
    10000^(-2i/d), rows [sin(p*w) || cos(p*w)] * scale."""
    freq_seq = np.arange(0, embedding_dim, 2.0, dtype=np.float64)
    inv_freq = 1.0 / np.power(10000.0, freq_seq / embedding_dim)
    sinusoid = np.outer(np.arange(0, max_len, 1.0), inv_freq)
    return (np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
            * scale).astype(np.float32)
