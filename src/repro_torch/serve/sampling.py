"""Counter-based sampling streams for the serve engine.

The reference engine samples a request's tokens from its own JAX key
stream, ``fold_in(base, uid)`` split once a token, so a request's tokens
do not depend on what shares its batch and continue exactly across
preemption. The port keeps those properties with a counter-based stream
instead of generator state: the Gumbel noise added to token ``j`` of
request ``uid`` is a pure function of (base seed, ``uid``, ``j``, vocab
index), computed on the logits' device with integer tensor ops, and the
token is ``argmax(logits / T + g)`` — a draw from ``softmax(logits / T)``.

- No generator a slot and no launch a slot; the decode step reads nothing
  back (no host sync).
- The state a slot carries is its stream key and the index of its next
  token; the resume state saved at preemption is that index, which the
  host already knows (the number of tokens emitted).
- The noise does not depend on the slot or the batch.
- The CPU and the card give the same noise bits: the hash runs on 32-bit
  lanes held in int64 (every product stays below 2**63), the uniform is an
  exact float32, and the two logarithms of the Gumbel transform are built
  from IEEE float32 ``+ - * /`` only (each its own op, so nothing is fused
  and every result is correctly rounded on both devices).

JAX's threefry bits are not reproduced: sampled tokens are compared with
the port's own runs (solo = batched, preempted = not), never with JAX's.
"""
from __future__ import annotations

import struct

import torch

M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a product of a 32-bit lane stays < 2**63
_MUL = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39, 0x61C88647)
_SEED_SALT, _CTR_SALT = 0x3C6EF372, 0x1B873593
_SQRT2 = 1.4142135381698608      # float32(sqrt(2))
_LN2 = 0.6931471824645996        # float32(ln 2)


def _f32(x: float) -> float:
    """``x`` rounded to float32: a constant every device reads alike."""
    return struct.unpack("f", struct.pack("f", x))[0]


# log(m) = s * P(s^2), s = (m - 1) / (m + 1): 2 * (1 + z/3 + z^2/5 + ...)
_LOG_POLY = tuple(_f32(2.0 / (2 * i + 1)) for i in range(8))


def _mix(x, a: int = 0, b: int = 1):
    """A 32-bit xorshift-multiply hash of the lanes of ``x`` (a Python int
    or an int64 tensor of values in [0, 2**32)); a bijection on 32 bits."""
    x = x ^ (x >> 16)
    x = (x * _MUL[a]) & M32
    x = x ^ (x >> 15)
    x = (x * _MUL[b]) & M32
    return x ^ (x >> 16)


def seed_of(rng) -> int:
    """The base seed of ``ServeConfig.rng``: an int, a ``torch.Generator``
    (its ``initial_seed()``), or None (seed 0, as the reference's
    ``PRNGKey(0)``)."""
    if rng is None:
        return 0
    if isinstance(rng, torch.Generator):
        return int(rng.initial_seed())
    return int(rng)


def stream_key(seed: int, uid: int) -> int:
    """The 32-bit key of request ``uid``'s stream under base ``seed``."""
    k = _mix((seed & M32) ^ _SEED_SALT)
    k = _mix(k ^ ((seed >> 32) & M32), 2, 3)
    k = _mix(k ^ (uid & M32))
    return _mix(k ^ ((uid >> 32) & M32), 2, 3)


def _log(x):
    """Natural log of a float32 tensor of positive normal values, from
    its bits and IEEE float32 ``+ - * /`` only (the same bits on every
    device)."""
    bits = x.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)   # [1, 2)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, _LOG_POLY[-1])
    for c in _LOG_POLY[-2::-1]:
        p = p * z
        p = p + c
    return s * p + e * _LN2


def gumbel(skey, ctr, vocab: int):
    """Gumbel noise [B, vocab] float32 of the streams ``skey`` ([B] int64
    stream keys) at token indices ``ctr`` ([B] int64), on their device."""
    rk = _mix(skey ^ _mix((ctr + _CTR_SALT) & M32, 2, 3))      # [B]
    v = torch.arange(vocab, device=skey.device, dtype=torch.int64)
    h = _mix(rk[:, None] ^ v)
    h = _mix((h + rk[:, None]) & M32, 2, 3)
    # an odd multiple of 2**-24 in (0, 1): exact in float32
    u = ((h >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -24)
    return -_log(-_log(u))


def sample(logits, temperature: float, skey, ctr):
    """Token [B] int32 drawn from ``softmax(logits / temperature)`` by the
    streams ``skey`` at indices ``ctr`` (Gumbel-max over the float32
    logits)."""
    g = gumbel(skey, ctr, logits.shape[-1])
    return torch.argmax(logits.float() / temperature + g,
                        dim=-1).to(torch.int32)
