"""Adaptive separable convolution (counterpart of ``vfi_tpu/ops/sepconv.py``).

For every output pixel ``(y, x)`` a vertical and a horizontal 1-D kernel of
length ``ks`` filter the ``ks x ks`` input window anchored at that pixel:

    out[b, y, x, c] = sum_{fy, fx} x[b, y+fy, x+fx, c] * v[b, y, x, fy] * h[b, y, x, fx]

Operands keep vfi_tpu's layouts: ``x`` is the pre-padded input
``[B, H+ks-1, W+ks-1, C]`` and ``v``, ``h`` are ``[B, H, W, ks]``.  Any strides
are accepted, so a kernel head's NCHW output permuted to ``[B, H, W, ks]``
goes in without a copy.

Implementations, each a plain PyTorch version beside a hand-written CUDA
kernel (``csrc/``) that is held against it:

  * forward, direct: :func:`sepconv_direct` (O(ks^2) accumulation, the spec);
    :func:`sepconv_fwd_cuda` (``sepconv_fwd.cu``, the counterpart of
    vfi_tpu's ``_sepconv_pallas_raw``).
  * forward, banded: :func:`sepconv_banded` (the horizontal pass as a matmul
    against the banded matrix ``S[b, y, x, u] = h[b, y, x, u-x]``);
    :func:`sepconv_fwd_mxu_cuda` (``sepconv_fwd_mxu.cu``, tensor cores, the
    counterpart of ``_sepconv_pallas_mxu_raw``); :func:`_sepconv_mxu_tiled`
    emulates that kernel's tiling and arithmetic (tests only).
  * adjoint for the kernels: :func:`sepconv_bwd_vh_plain`;
    :func:`sepconv_bwd_vh_cuda` (``sepconv_bwd_vh.cu``).
  * adjoint for the input: :func:`sepconv_bwd_x_plain`;
    :func:`sepconv_bwd_x_cuda` (``sepconv_bwd_x.cu``).

:func:`sepconv` dispatches on vfi_tpu's ``impl`` values: ``"direct"`` and
``"mxu"`` are the plain versions (autograd through them) on either device;
``"pallas"`` and ``"pallas_mxu"`` go through :class:`SepConv`, which takes
the plain versions for CPU tensors and the kernels for CUDA tensors, forward
and backward.  The plain versions compute in float32 (float64 stays float64)
and return the operands' dtype.
"""

from __future__ import annotations

from typing import Literal, Optional, get_args

import torch
import torch.nn.functional as F

Impl = Literal["direct", "mxu", "pallas", "pallas_mxu"]
IMPLS = get_args(Impl)

# Launches of each CUDA kernel; each is incremented by its wrapper only.
sepconv_fwd_launches = 0
sepconv_fwd_mxu_launches = 0
sepconv_bwd_vh_launches = 0
sepconv_bwd_x_launches = 0


def _check_shapes(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Validate operand shapes; returns (B, H, W, C, ks)."""
    if x.ndim != 4 or v.ndim != 4 or h.ndim != 4:
        raise ValueError(
            f"sepconv expects rank-4 operands (x=[B,Hp,Wp,C], v/h=[B,H,W,ks]); "
            f"got x{tuple(x.shape)} v{tuple(v.shape)} h{tuple(h.shape)}"
        )
    B, H, W, ks = v.shape
    if tuple(h.shape) != (B, H, W, ks):
        raise ValueError(f"vertical {tuple(v.shape)} and horizontal {tuple(h.shape)} kernel shapes differ")
    Bx, Hp, Wp, C = x.shape
    if Bx != B or Hp != H + ks - 1 or Wp != W + ks - 1:
        raise ValueError(
            f"input must be pre-padded to [B, H+ks-1, W+ks-1, C] = "
            f"[{B}, {H + ks - 1}, {W + ks - 1}, C]; got {tuple(x.shape)}"
        )
    return B, H, W, C, ks


def _check_cotangent(g: torch.Tensor, B: int, H: int, W: int, C: int) -> None:
    if tuple(g.shape) != (B, H, W, C):
        raise ValueError(f"cotangent must be [B, H, W, C] = [{B}, {H}, {W}, {C}]; got {tuple(g.shape)}")


def _check_adjoint_shapes(v: torch.Tensor, h: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Validate the operands of the input adjoint; returns (B, H, W, C, ks)."""
    if v.ndim != 4 or g.ndim != 4 or tuple(h.shape) != tuple(v.shape):
        raise ValueError(f"sepconv's input adjoint expects v, h [B,H,W,ks] and g [B,H,W,C]; "
                         f"got v{tuple(v.shape)} h{tuple(h.shape)} g{tuple(g.shape)}")
    B, H, W, ks = v.shape
    C = g.shape[-1]
    _check_cotangent(g, B, H, W, C)
    return B, H, W, C, ks


def _wide(t: torch.Tensor) -> torch.Tensor:
    """At least float32 (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def pad_for_sepconv(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Replication-pad an NHWC image by floor(ks/2) per side (one more at the
    bottom and right for even ks), giving ``[B, H+ks-1, W+ks-1, C]``."""
    p = ks // 2
    q = p + (ks - 1 - 2 * p)
    xp = F.pad(x.permute(0, 3, 1, 2), (p, q, p, q), mode="replicate")
    return xp.permute(0, 2, 3, 1)


def sepconv_direct(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Elementwise accumulation over the ks x ks taps, in float32."""
    B, H, W, C, ks = _check_shapes(x, v, h)
    xf, vf, hf = _wide(x), _wide(v), _wide(h)
    out = torch.zeros((B, H, W, C), dtype=xf.dtype, device=x.device)
    for fy in range(ks):
        rows = xf[:, fy : fy + H]  # [B, H, W+ks-1, C]
        inner = torch.zeros_like(out)
        for fx in range(ks):
            inner += rows[:, :, fx : fx + W] * hf[..., fx : fx + 1]
        out += inner * vf[..., fy : fy + 1]
    return out.to(x.dtype)


def _skew_rows(m: torch.Tensor) -> torch.Tensor:
    """``[..., W, ks] -> [..., W, W+ks-1]`` with ``out[..., x, u] = m[..., x, u-x]``
    for ``0 <= u-x < ks``, else 0 (pad each row to ``ks+W``, flatten, re-slice
    at stride ``ks+W-1``)."""
    *lead, W, ks = m.shape
    padded = F.pad(m, (0, W))  # [..., W, ks+W]
    flat = padded.reshape(*lead, W * (ks + W))[..., : W * (ks + W - 1)]
    return flat.reshape(*lead, W, ks + W - 1)


def _unskew_rows(m: torch.Tensor, ks: int) -> torch.Tensor:
    """``[..., W, W+ks-1] -> [..., W, ks]`` with ``out[..., x, j] = m[..., x, x+j]``
    (the inverse of :func:`_skew_rows` on the band), by gather."""
    W = m.shape[-2]
    idx = torch.arange(W, device=m.device)[:, None] + torch.arange(ks, device=m.device)
    return m.gather(-1, idx.expand(*m.shape[:-1], ks))


def _row_slabs(x: torch.Tensor, H: int, ks: int) -> torch.Tensor:
    """``slabs[b, y, f, u, c] = x[b, y+f, u, c]``: ``[B, H, ks, W+ks-1, C]``."""
    return torch.stack([x[:, f : f + H] for f in range(ks)], dim=2)


def sepconv_banded(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Banded-matmul formulation, computed in float32:

        inner[b, y, fy, x, c] = sum_u x[b, y+fy, u, c] * S[b, y, x, u]
        out[b, y, x, c]       = sum_fy inner[b, y, fy, x, c] * v[b, y, x, fy]
    """
    B, H, W, C, ks = _check_shapes(x, v, h)
    inner = torch.einsum("byfuc,byxu->byfxc", _row_slabs(_wide(x), H, ks), _skew_rows(_wide(h)))
    out = torch.einsum("byfxc,byxf->byxc", inner, _wide(v))
    return out.to(x.dtype)


# The banded kernel's column tile (``TW`` in ``csrc/sepconv_fwd_mxu.cu``).
MXU_TILE_W = 128


def _split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``a`` as ``hi + lo``, each a bfloat16 number held in float32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _sepconv_mxu_tiled(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Torch emulation of ``sepconv_fwd_mxu.cu``'s tiling and arithmetic, for
    the tests: it is on no path.

    Columns go in tiles of ``MXU_TILE_W``, the last one zero-padded.  Per
    output row and column tile, S^T ``[TW, K]`` is a zeroed buffer into which
    the row's band is written; K (``TW+ks-1`` input columns) is zero-padded to
    a multiple of 16 and the taps (M) are padded to a multiple of 16 by
    repeating the last slab row, whose products meet zero vertical taps.
    float32 operands multiply as the bf16 split ``hi*hi + lo*hi + hi*lo``;
    bfloat16 operands as they are.  Products and sums are float32.
    """
    B, H, W, C, ks = _check_shapes(x, v, h)
    tw = MXU_TILE_W
    split = x.dtype != torch.bfloat16
    nw = -(-W // tw)
    ku = tw + ks - 1
    kp = -(-ku // 16) * 16
    mp = -(-ks // 16) * 16
    dev = x.device
    xf = F.pad(_wide(x), (0, 0, 0, nw * tw - W))  # [B, Hp, nw*tw+ks-1, C]
    vf = F.pad(_wide(v), (0, mp - ks, 0, nw * tw - W))  # [B, H, nw*tw, mp]
    hf = F.pad(_wide(h), (0, 0, 0, nw * tw - W))  # [B, H, nw*tw, ks]
    taps = torch.arange(mp, device=dev).clamp(max=ks - 1)
    rows = torch.arange(H, device=dev)[:, None] + taps  # [H, mp]
    band = (torch.arange(tw, device=dev)[:, None] + torch.arange(ks, device=dev)).expand(B, H, tw, ks)
    tiles = []
    for j in range(nw):
        slab = F.pad(xf[:, :, j * tw : j * tw + ku], (0, 0, 0, kp - ku))[:, rows]  # [B, H, mp, kp, C]
        st = torch.zeros((B, H, tw, kp), dtype=xf.dtype, device=dev)
        st.scatter_(-1, band, hf[:, :, j * tw : (j + 1) * tw])  # st[.., x, x+f] = h[.., x, f]
        if split:
            (a_hi, a_lo), (s_hi, s_lo) = _split_bf16(slab), _split_bf16(st)
            pairs = ((a_hi, s_hi), (a_lo, s_hi), (a_hi, s_lo))
        else:
            pairs = ((slab, st),)
        inner = sum(torch.einsum("byfuc,byxu->byfxc", a, s) for a, s in pairs)
        tiles.append(torch.einsum("byfxc,byxf->byxc", inner, vf[:, :, j * tw : (j + 1) * tw]))
    return torch.cat(tiles, dim=2)[:, :, :W].to(x.dtype)


def sepconv_bwd_vh_plain(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor,
                         g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Adjoints for the per-pixel kernels, summed over channels (banded form):

        grad_v[b, y, x, f] = sum_c g[b, y, x, c] * sum_j x[b, y+f, x+j, c] * h[b, y, x, j]
        grad_h[b, y, x, j] = sum_c g[b, y, x, c] * sum_f v[b, y, x, f] * x[b, y+f, x+j, c]

    ``grad_v`` contracts the recomputed horizontal pass with g; ``grad_h``
    unskews ``A[b, y, x, u] = sum_{f,c} g*v[b, y, x, f] * x[b, y+f, u, c]``.
    """
    B, H, W, C, ks = _check_shapes(x, v, h)
    _check_cotangent(g, B, H, W, C)
    slabs = _row_slabs(_wide(x), H, ks)
    gw = _wide(g)
    inner = torch.einsum("byfuc,byxu->byfxc", slabs, _skew_rows(_wide(h)))
    grad_v = torch.einsum("byfxc,byxc->byxf", inner, gw)
    gv = _wide(v)[..., :, None] * gw[..., None, :]  # [B, H, W, ks, C]
    grad_h = _unskew_rows(torch.einsum("byfuc,byxfc->byxu", slabs, gv), ks)
    return grad_v.to(v.dtype), grad_h.to(h.dtype)


def sepconv_bwd_x_plain(v: torch.Tensor, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Adjoint for the padded input (banded form):

        grad_x[b, s, u, c] = sum_{f,j} g[b, s-f, u-j, c] * v[b, s-f, u-j, f] * h[b, s-f, u-j, j]

    Per output row y, ``G[b, y, f, u, c] = sum_x g*v[b, y, x, f, c] * S[b, y, x, u]``;
    the rows overlap-add into ``grad_x[b, y+f]`` in a loop over f.
    """
    B, H, W, C, ks = _check_adjoint_shapes(v, h, g)
    gv = _wide(v)[..., :, None] * _wide(g)[..., None, :]  # [B, H, W, ks, C]
    G = torch.einsum("byxfc,byxu->byfuc", gv, _skew_rows(_wide(h)))  # [B, H, ks, W+ks-1, C]
    grad_x = torch.zeros((B, H + ks - 1, W + ks - 1, C), dtype=G.dtype, device=G.device)
    for f in range(ks):
        grad_x[:, f : f + H] += G[:, :, f]
    return grad_x.to(g.dtype)


def _check_kernel_operands(fn: str, C: int, ks: int, **tensors: torch.Tensor) -> None:
    """What every CUDA wrapper checks before a launch; raises ValueError."""
    from . import _kernels

    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn} needs CUDA tensors; {name} is on {t.device}")
    ts = list(tensors.values())
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{fn}: operands on different devices: {[str(t.device) for t in ts]}")
    if ts[0].dtype not in (torch.float32, torch.bfloat16) or len({t.dtype for t in ts}) != 1:
        raise ValueError(f"{fn} takes float32 or bfloat16 operands of one dtype; got {[t.dtype for t in ts]}")
    if not 1 <= C <= _kernels.SEPCONV_MAX_CHANNELS:
        raise ValueError(f"{fn} takes 1..{_kernels.SEPCONV_MAX_CHANNELS} channels; got C={C}")
    if not 1 <= ks <= _kernels.SEPCONV_MAX_KS:
        raise ValueError(f"{fn} takes 1 <= ks <= {_kernels.SEPCONV_MAX_KS}; got ks={ks}")


def sepconv_fwd_cuda(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Launch the direct-accumulation CUDA forward kernel on CUDA tensors.

    Counterpart of vfi_tpu's Pallas kernel ``_sepconv_pallas_raw``
    (``impl="pallas"``).  Raises on anything the kernel does not take; never
    falls back.
    """
    global sepconv_fwd_launches
    from . import _kernels

    B, H, W, C, ks = _check_shapes(x, v, h)
    _check_kernel_operands("sepconv_fwd_cuda", C, ks, x=x, v=v, h=h)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _kernels.launch("sepconv_fwd", (x, v, h, out), B, H, W, C, ks)
    sepconv_fwd_launches += 1
    return out


def sepconv_fwd_mxu_cuda(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Launch the banded tensor-core CUDA forward kernel on CUDA tensors.

    Counterpart of vfi_tpu's Pallas kernel ``_sepconv_pallas_mxu_raw``
    (``impl="pallas_mxu"``, the default on CUDA).  Raises on anything the
    kernel does not take, including a float32 call whose tiles do not fit a
    block's shared memory (4 channels at ks=51); never falls back.
    """
    global sepconv_fwd_mxu_launches
    from . import _kernels

    B, H, W, C, ks = _check_shapes(x, v, h)
    _check_kernel_operands("sepconv_fwd_mxu_cuda", C, ks, x=x, v=v, h=h)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _kernels.launch("sepconv_fwd_mxu", (x, v, h, out), B, H, W, C, ks)
    sepconv_fwd_mxu_launches += 1
    return out


def sepconv_bwd_vh_cuda(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor,
                        g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel-adjoint kernel: (grad_v, grad_h), summed over channels.

    Counterpart of vfi_tpu's Pallas kernel ``_sepconv_pallas_bwd_vh_raw``.
    The gradients are allocated like v and h (same strides), so a permuted
    view's backward needs no copy.  Raises on anything the kernel does not
    take; never falls back.
    """
    global sepconv_bwd_vh_launches
    from . import _kernels

    B, H, W, C, ks = _check_shapes(x, v, h)
    _check_cotangent(g, B, H, W, C)
    _check_kernel_operands("sepconv_bwd_vh_cuda", C, ks, x=x, v=v, h=h, g=g)
    grad_v, grad_h = torch.empty_like(v), torch.empty_like(h)
    if grad_v.numel() == 0:
        return grad_v, grad_h
    with torch.cuda.device(x.device):
        _kernels.launch("sepconv_bwd_vh", (x, v, h, g, grad_v, grad_h), B, H, W, C, ks)
    sepconv_bwd_vh_launches += 1
    return grad_v, grad_h


def sepconv_bwd_x_cuda(v: torch.Tensor, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA input-adjoint kernel: grad_x ``[B, H+ks-1, W+ks-1, C]``.

    Counterpart of vfi_tpu's Pallas kernel ``_sepconv_pallas_bwd_x_raw``.
    Raises on anything the kernel does not take; never falls back.
    """
    global sepconv_bwd_x_launches
    from . import _kernels

    B, H, W, C, ks = _check_adjoint_shapes(v, h, g)
    _check_kernel_operands("sepconv_bwd_x_cuda", C, ks, v=v, h=h, g=g)
    grad_x = torch.empty((B, H + ks - 1, W + ks - 1, C), dtype=g.dtype, device=g.device)
    if v.numel() == 0:
        return grad_x.zero_()
    with torch.cuda.device(g.device):
        _kernels.launch("sepconv_bwd_x", (v, h, g, grad_x), B, H, W, C, ks)
    sepconv_bwd_x_launches += 1
    return grad_x


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class SepConv(torch.autograd.Function):
    """sepconv with its adjoints: the plain versions on CPU tensors, the CUDA
    kernels on CUDA tensors (which raise on what they cannot run).

    ``impl`` picks the forward: ``"pallas"`` the direct one
    (:func:`sepconv_direct` / :func:`sepconv_fwd_cuda`), ``"pallas_mxu"`` the
    banded one (:func:`sepconv_banded` / :func:`sepconv_fwd_mxu_cuda`).  The
    backward is the same for both, as in vfi_tpu, whose two Pallas forwards
    share the adjoint of the banded formulation.
    """

    @staticmethod
    def forward(ctx, x, v, h, impl="pallas_mxu"):
        ctx.save_for_backward(x, v, h)
        if impl == "pallas":
            return (sepconv_direct if _on_cpu(x, v, h) else sepconv_fwd_cuda)(x, v, h)
        return (sepconv_banded if _on_cpu(x, v, h) else sepconv_fwd_mxu_cuda)(x, v, h)

    @staticmethod
    def backward(ctx, g):
        x, v, h = ctx.saved_tensors
        need_x, need_v, need_h = ctx.needs_input_grad[:3]
        cpu = _on_cpu(x, v, h, g)
        grad_x = grad_v = grad_h = None
        if need_v or need_h:
            grad_v, grad_h = (sepconv_bwd_vh_plain if cpu else sepconv_bwd_vh_cuda)(x, v, h, g)
        if need_x:
            grad_x = (sepconv_bwd_x_plain if cpu else sepconv_bwd_x_cuda)(v, h, g)
        return grad_x, grad_v if need_v else None, grad_h if need_h else None, None


def sepconv(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor, impl: Optional[Impl] = None) -> torch.Tensor:
    """Adaptive separable convolution, differentiable in all three operands.

    :param x: pre-padded input ``[B, H+ks-1, W+ks-1, C]`` (:func:`pad_for_sepconv`)
    :param v: per-pixel vertical kernels ``[B, H, W, ks]``
    :param h: per-pixel horizontal kernels ``[B, H, W, ks]``
    :param impl: vfi_tpu's names: ``"direct"`` and ``"mxu"`` are the plain
        versions on either device; ``"pallas"`` and ``"pallas_mxu"`` are the
        direct and the banded CUDA kernel on CUDA operands (which raise on what
        they cannot run) and the plain versions on CPU operands.  ``None``:
        ``"pallas_mxu"`` on CUDA, ``"mxu"`` on the CPU.
    :return: ``[B, H, W, C]`` in the input dtype
    """
    if impl is None:
        impl = "mxu" if _on_cpu(x, v, h) else "pallas_mxu"
    if impl == "direct":
        return sepconv_direct(x, v, h)
    if impl == "mxu":
        return sepconv_banded(x, v, h)
    if impl in ("pallas", "pallas_mxu"):
        return SepConv.apply(x, v, h, impl)
    raise ValueError(f"unknown sepconv impl {impl!r}; one of {IMPLS} or None")
