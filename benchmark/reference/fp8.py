"""The control: the reference with its bf16 matmuls taken one precision
lower, to fp8, as an fp8 training recipe runs them.

Each patched ``nn.Linear`` multiplies fp8 values: forward, the input and
the weight in e4m3; backward, the output's gradient in e5m2 against the
e4m3 input and weight. Each tensor is scaled per tensor so that its
largest magnitude meets the format's largest finite value. Accumulation and
everything outside the patched layers stay float32.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in f32."""
    top = torch.finfo(dtype).max
    amax = torch.clamp(x.detach().abs().amax(), min=1e-30).float()
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale)


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = quantize(x, E4M3), quantize(w, E4M3)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        y = xq @ wq.t()
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = quantize(gy, E5M2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def _forward(self, x):
    return _Fp8Linear.apply(x.float(), self.weight, self.bias)


def use_fp8(modules: Iterable[nn.Module]) -> int:
    """Patch every ``nn.Linear`` inside ``modules``; returns how many."""
    n = 0
    for root in modules:
        for m in root.modules():
            if isinstance(m, nn.Linear):
                m.forward = _forward.__get__(m, nn.Linear)
                n += 1
    return n
