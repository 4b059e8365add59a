"""Batched 6-D spatial vector algebra (world-axis, per-body-origin frames).

Spatial motion vectors are (angular; linear) 6-vectors; force vectors are
(moment; force). All quantities are expressed in world axes at a stated
origin; transports between origins are pure translations, so the
Featherstone passes carry no rotation bookkeeping (rotations enter only
through the joint motion subspaces and per-body inertia).

Everything broadcasts over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch

from reference.utils.rotation import cross


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def motion(ang: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    return torch.cat([ang, lin], dim=-1)


def ang(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0:3]


def lin(m: torch.Tensor) -> torch.Tensor:
    return m[..., 3:6]


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v x_m m (motion-cross-motion)."""
    w, u = v[..., 0:3], v[..., 3:6]
    mw, mu = m[..., 0:3], m[..., 3:6]
    return motion(cross(w, mw), cross(w, mu) + cross(u, mw))


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v x* f (motion-cross-force)."""
    w, u = v[..., 0:3], v[..., 3:6]
    n, fo = f[..., 0:3], f[..., 3:6]
    return motion(cross(w, n) + cross(u, fo), cross(w, fo))


def shift_motion(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Transport a motion vector from origin o to origin o + r."""
    w, u = m[..., 0:3], m[..., 3:6]
    return motion(w, u + cross(w, r))


def shift_force(f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Transport a force vector from origin o + r to origin o (the moment
    picks up r x f)."""
    n, fo = f[..., 0:3], f[..., 3:6]
    return motion(n + cross(r, fo), fo)


def shift_inertia(ia: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Transport a 6x6 articulated inertia from origin o + r to origin o.

    If f_child = IA v_child with quantities at the child origin, the
    equivalent inertia at the parent origin is X_F(r) @ IA @ X_M(-r) where
    X_M maps parent-origin motion to child-origin motion.
    """
    rx = skew(r)
    eye = torch.eye(3, dtype=ia.dtype, device=ia.device).expand(rx.shape)
    zero = torch.zeros_like(rx)
    # X_F = [[1, rx], [0, 1]] ; X_M = [[1, 0], [-rx, 1]]
    xf = torch.cat([torch.cat([eye, rx], -1), torch.cat([zero, eye], -1)], -2)
    xm = torch.cat([torch.cat([eye, zero], -1), torch.cat([-rx, eye], -1)], -2)
    return xf @ ia @ xm


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body origin, world axes.

    Args:
      mass: (...,) body mass.
      com: (..., 3) com offset from the body origin (world axes).
      inertia_com: (..., 3, 3) rotational inertia about the com (world axes).
    """
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(cx.shape)
    top_left = inertia_com + m * (cx @ cx.transpose(-1, -2))
    top_right = m * cx
    bot_left = m * cx.transpose(-1, -2)
    bot_right = m * eye
    return torch.cat([torch.cat([top_left, top_right], -1),
                      torch.cat([bot_left, bot_right], -1)], -2)
