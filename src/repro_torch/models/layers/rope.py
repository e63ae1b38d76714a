"""Rotary position embeddings with partial-rotary support (interleaved-pair
convention, as in the JAX package's ``rope.py``)."""
from __future__ import annotations

import torch


def rotary_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions [*P] -> (cos, sin) each [*P, dim//2] in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def rotor(angles) -> torch.Tensor:
    """``rotary_angles``' (cos, sin) [B, S, rot//2] -> the rotation
    cos + i sin as a complex [B, S, 1, rot//2], broadcast over heads."""
    cos, sin = angles
    return torch.complex(cos, sin)[:, :, None, :]


def rotary_dims(dh: int, partial_factor: float = 1.0) -> int:
    """How many leading dims of a head are rotated (even)."""
    rot = int(dh * partial_factor)
    return rot - rot % 2


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial_factor: float = 1.0, rot_c=None) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] or [S] (unused when ``rot_c``
    is given). Rotates the first
    ``partial_factor * Dh`` dims as interleaved pairs (0,1), (2,3), ... and
    passes the rest through unchanged. ``rot_c``: ``rotor`` of these
    positions, when the caller shares it across q, k and layers."""
    dh = x.shape[-1]
    rot = rotary_dims(dh, partial_factor)
    if rot == 0:
        return x
    x_rot = x if rot == dh else x[..., :rot]
    if rot_c is None:
        if positions.ndim == 1:
            positions = positions[None, :]
        rot_c = rotor(rotary_angles(positions, rot, theta))
    # each interleaved pair (x1, x2) is the complex number x1 + i x2; the
    # rotation (x1 cos - x2 sin, x2 cos + x1 sin) is a product with
    # cos + i sin (one kernel instead of a handful: decode is launch-bound)
    xc = torch.view_as_complex(
        x_rot.float().reshape(*x_rot.shape[:-1], rot // 2, 2))
    out = torch.view_as_real(xc * rot_c).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < dh else out
