"""Both NGP MLP heads, forward and backward: CUDA kernels for Hopper + plain versions.

Counterpart: ngp_tpu/ops/fused_mlp.py:57-68 (supports), :91-104
(_fwd_kernel) and :107-168 (_bwd_kernel), the Pallas kernels these
replace, :175-246 (fused_heads and its custom_vjp) and :249-260
(split_first_rgb, fused_rgbsigma). Differs: the kernels are CUDA C++ for
sm_90a (csrc/fused_mlp_fwd.cu, csrc/fused_mlp_bwd.cu), built with nvcc at
first use (ops/kernels.py) and bound through ctypes; they are the CUDA path
of NGPModel.rgbsigma_raw whenever `supports()` holds, with no opt-in switch
(the per-pallas_call dispatch tax that made the TPU kernels opt-in does not
exist here). The ragged last row tile is masked inside the kernels instead
of padding N in the wrapper. The backward's weight gradients are reduced
across blocks by a second launch in a fixed order (the Pallas kernel's
sequential grid `+=` has no CUDA counterpart).

`fused_mlp_fwd` and `fused_mlp_bwd` launch their kernels for CUDA tensors
and run the plain versions for CPU tensors; there is no other fallback.
`fused_heads` wraps the pair in a torch.autograd.Function. The kernels are
instantiated per width bucket (`mlp_bucket`: 32, 64 or 128, the widest
padded width); each set of padded widths gets one launch plan per device
(bucket, grid, shared memory), computed at its first launch and cached.
"""

import ctypes
import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.ops.mlp import bf16_round
from ngp_tpu_torch.utils import profiling

RGB_OUT = 3


def supports(dcfg, rcfg) -> bool:
    """The fused path covers bias-free ReLU heads up to width 128."""
    return (
        dcfg.activation.lower() == "relu"
        and dcfg.output_activation.lower() == "none"
        and rcfg.activation.lower() == "relu"
        and rcfg.output_activation.lower() == "none"
        and dcfg.n_neurons <= 128
        and rcfg.n_neurons <= 128
        and dcfg.n_hidden_layers >= 1
        and rcfg.n_hidden_layers >= 1
    )


def split_first_rgb(rgb_weights, dd: int):
    """[(dd+ds, W), ...] -> [(dd, W), (ds, W), ...]: algebraize the concat."""
    v0 = rgb_weights[0]
    return [v0[:dd], v0[dd:], *rgb_weights[1:]]


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


@dataclass(frozen=True)
class FusedWeights:
    """Both heads' weights, zero-padded to multiples of 16 and packed into one
    bf16 buffer in the kernels' order (csrc/fused_mlp.cuh header)."""

    packed: torch.Tensor  # (w_elems,) bf16
    d_in: int  # padded widths
    d_sh: int
    wd: int
    wr: int
    dd: int
    nd: int  # density layers
    nr: int  # rgb layers after the V0 split
    d_in_real: int
    d_sh_real: int
    dd_real: int
    wd_real: int = 0
    wr_real: int = 0

    def shapes(self):
        """Padded (in, out) shape of each packed matrix, in order."""
        d = [(self.d_in, self.wd)] + [(self.wd, self.wd)] * (self.nd - 2) + [(self.wd, self.dd)]
        r = [(self.dd, self.wr), (self.d_sh, self.wr)] + [(self.wr, self.wr)] * (self.nr - 3) + [(self.wr, 16)]
        return d, r

    def matrices(self):
        """(density, rgb) lists of bf16 views into `packed`."""
        d_shapes, r_shapes = self.shapes()
        out, pos = [], 0
        for k, n in d_shapes + r_shapes:
            out.append(self.packed[pos : pos + k * n].view(k, n))
            pos += k * n
        return out[: len(d_shapes)], out[len(d_shapes) :]


def pack_weights(dweights, rgb_weights) -> FusedWeights:
    """fp32 (in, out) head matrices -> FusedWeights on their device.

    rgb_weights is the unsplit list whose first matrix takes concat(dens, sh)."""
    nd, n_rgb = len(dweights), len(rgb_weights)
    if nd < 2 or n_rgb < 2:
        raise ValueError("fused MLP needs at least one hidden layer per head")
    dd_real = dweights[-1].shape[1]
    rw = split_first_rgb(list(rgb_weights), dd_real)
    d_in_real, d_sh_real = dweights[0].shape[0], rw[1].shape[0]
    wd, wr = _pad16(dweights[0].shape[1]), _pad16(rw[0].shape[1])
    if wd > 128 or wr > 128:
        raise ValueError(f"fused MLP takes widths up to 128, got {wd}, {wr}")
    if rw[-1].shape[1] != RGB_OUT:
        raise ValueError(f"rgb head must output {RGB_OUT} channels, got {rw[-1].shape[1]}")
    fw = FusedWeights(
        packed=torch.empty(0),
        d_in=_pad16(d_in_real),
        d_sh=_pad16(d_sh_real),
        wd=wd,
        wr=wr,
        dd=_pad16(dd_real),
        nd=nd,
        nr=len(rw),
        d_in_real=d_in_real,
        d_sh_real=d_sh_real,
        dd_real=dd_real,
        wd_real=dweights[0].shape[1],
        wr_real=rw[0].shape[1],
    )
    d_shapes, r_shapes = fw.shapes()
    parts = []
    for w, (k, n) in zip(list(dweights) + rw, d_shapes + r_shapes, strict=True):
        if w.shape[0] > k or w.shape[1] > n:
            raise ValueError(f"weight {tuple(w.shape)} does not fit the padded slot {(k, n)}")
        parts.append(F.pad(w.detach().to(torch.float32), (0, n - w.shape[1], 0, k - w.shape[0])).reshape(-1))
    packed = torch.cat(parts).to(torch.bfloat16).contiguous()
    return dataclasses.replace(fw, packed=packed)


def _pad_cols(x: torch.Tensor, cols: int) -> torch.Tensor:
    return x if x.shape[1] == cols else F.pad(x, (0, cols - x.shape[1]))


def fused_mlp_fwd_plain(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """The kernel's function in plain torch: (rgb (N, 3), dens (N, dd)) fp32.

    bf16-rounded operands multiplied in fp32 (exact products, fp32 sums),
    ReLU in fp32, bf16 re-cast between layers."""
    dmats, rmats = fw.matrices()
    h = _pad_cols(enc.to(torch.float32), fw.d_in)
    for i, w in enumerate(dmats):
        h = bf16_round(h) @ w.to(torch.float32)
        if i < len(dmats) - 1:
            h = torch.relu(h)
    dens = h
    s = _pad_cols(sh.to(torch.float32), fw.d_sh)
    r = torch.relu(bf16_round(dens) @ rmats[0].to(torch.float32) + bf16_round(s) @ rmats[1].to(torch.float32))
    for w in rmats[2:-1]:
        r = torch.relu(bf16_round(r) @ w.to(torch.float32))
    rgb = bf16_round(r) @ rmats[-1].to(torch.float32)
    return rgb[:, :RGB_OUT], dens[:, : fw.dd_real]


# --------------------------------------------------------------- backward
def fused_mlp_bwd_plain(enc, sh, g_rgb, g_dens, fw: FusedWeights):
    """_bwd_kernel's function in plain torch: recompute the forward, keep the
    fp32 hidden activations, backprop g_rgb (N, 3) and g_dens (N, dd_real).
    Returns (d_enc (N, d_in_real), weight gradients as one flat fp32 tensor
    in the packed, padded order of `fw`). Every product takes bf16-rounded
    operands and sums in fp32; ReLU masks come from the fp32 activations."""
    dmats, rmats = (list(m) for m in fw.matrices())
    nd, nr = fw.nd, fw.nr
    x = _pad_cols(enc.to(torch.float32), fw.d_in)
    s = _pad_cols(sh.to(torch.float32), fw.d_sh)
    acts, h = [x], x
    for i, w in enumerate(dmats):
        h = bf16_round(h) @ w.to(torch.float32)
        if i < nd - 1:
            h = torch.relu(h)
            acts.append(h)
    dens = h
    r = torch.relu(bf16_round(dens) @ rmats[0].to(torch.float32) + bf16_round(s) @ rmats[1].to(torch.float32))
    rhid = [r]
    for w in rmats[2:-1]:
        r = torch.relu(bf16_round(r) @ w.to(torch.float32))
        rhid.append(r)

    def tn(a, b):  # a.T @ b
        return bf16_round(a).T @ bf16_round(b)

    def nt(g, w):  # g @ w.T
        return bf16_round(g) @ w.to(torch.float32).T

    grads = [None] * (nd + nr)
    g = _pad_cols(g_rgb.to(torch.float32), 16)
    grads[-1] = tn(rhid[-1], g)
    g = nt(g, rmats[-1]) * (rhid[-1] > 0.0)
    for k in range(nr - 4, -1, -1):  # middle rgb layers rmats[2 + k], input rhid[k]
        grads[nd + 2 + k] = tn(rhid[k], g)
        g = nt(g, rmats[2 + k]) * (rhid[k] > 0.0)
    grads[nd] = tn(dens, g)
    grads[nd + 1] = tn(s, g)
    g = nt(g, rmats[0]) + _pad_cols(g_dens.to(torch.float32), fw.dd)
    grads[nd - 1] = tn(acts[-1], g)
    g = nt(g, dmats[-1])
    for k in range(nd - 2, -1, -1):
        g = g * (acts[k + 1] > 0.0)
        grads[k] = tn(acts[k], g)
        g = nt(g, dmats[k])
    return g[:, : fw.d_in_real], torch.cat([gr.reshape(-1) for gr in grads])


def unpack_grads(fw: FusedWeights, flat: torch.Tensor):
    """Flat packed-order gradients -> (density list, rgb list) in the heads'
    own (in, out) shapes: padding stripped, V0a/V0b joined back into V0."""
    d_shapes, r_shapes = fw.shapes()
    mats, pos = [], 0
    for k, n in d_shapes + r_shapes:
        mats.append(flat[pos : pos + k * n].view(k, n))
        pos += k * n
    nd = fw.nd
    wd, wr = fw.wd_real, fw.wr_real
    dg = [mats[0][: fw.d_in_real, :wd]] + [m[:wd, :wd] for m in mats[1 : nd - 1]] + [mats[nd - 1][:wd, : fw.dd_real]]
    rm = mats[nd:]
    v0 = torch.cat([rm[0][: fw.dd_real, :wr], rm[1][: fw.d_sh_real, :wr]], dim=0)
    rg = [v0] + [m[:wr, :wr] for m in rm[2:-1]] + [rm[-1][:wr, :RGB_OUT]]
    return dg, rg


# ---------------------------------------------------------------- kernels
BUCKETS = (32, 64, 128)  # the kernels' instantiations by largest padded width
BWD_REG_SLOTS, BWD_REG_WARPS = 24, 4  # m16n8 tiles a warp (2 x kSlots pairs) and kRegWarps of csrc/fused_mlp_bwd.cu
BWD_TILE_ROWS = 16  # rows a warp owns (a block's tile: 16 x warps rows)


def mlp_bucket(fw: FusedWeights) -> int:
    """The kernels' instantiation for these padded widths: the smallest
    bucket that holds every width the heads pass between layers (register
    arrays have compile-time sizes); raises above 128."""
    widest = max(fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, 16)
    for b in BUCKETS:
        if widest <= b:
            return b
    raise ValueError(f"the fused MLP kernels take padded widths up to {BUCKETS[-1]}, got {widest}")


def weight_tiles(fw: FusedWeights) -> int:
    """m16n8 tiles of all weight gradients (the backward's units of work)."""
    d_shapes, r_shapes = fw.shapes()
    return sum((k // 16) * (n // 8) for k, n in d_shapes + r_shapes)


def bwd_sums_in_registers(fw: FusedWeights) -> bool:
    """Whether the backward keeps its weight-gradient sums in registers (the
    32- and 64-wide buckets, up to BWD_REG_SLOTS tiles a warp) rather than in
    shared memory (the 128-wide bucket, deeper heads)."""
    return mlp_bucket(fw) <= 64 and weight_tiles(fw) <= BWD_REG_SLOTS * BWD_REG_WARPS


def _dims(fw: FusedWeights):
    return fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr


def _fwd_library():
    lib = kernels.library("fused_mlp_fwd")
    p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_mlp_fwd.argtypes = [p, p, p, p, p] + [i] * 11 + [p]
    lib.fused_mlp_fwd.restype = i
    lib.fused_mlp_fwd_plan.argtypes = [i] * 8 + [pi, pi]
    lib.fused_mlp_fwd_plan.restype = i
    return lib


def _bwd_library():
    lib = kernels.library("fused_mlp_bwd")
    p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_mlp_bwd.argtypes = [p] * 8 + [i] * 13 + [p]
    lib.fused_mlp_bwd.restype = i
    lib.fused_mlp_bwd_plan.argtypes = [i] * 9 + [pi, pi, pi]
    lib.fused_mlp_bwd_plan.restype = i
    return lib


# launch plans by (padded dimensions, device index): computed once, so a
# launch is one ctypes call
_FWD_PLANS: dict = {}
_BWD_PLANS: dict = {}


def _fwd_plan(fw: FusedWeights, device):
    """(lib, bucket, grid, shared memory bytes) of the forward kernel."""
    key = (_dims(fw), device.index)
    if key not in _FWD_PLANS:
        lib = _fwd_library()
        bucket = mlp_bucket(fw)
        grid, got = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.fused_mlp_fwd_plan(bucket, *_dims(fw), ctypes.byref(grid), ctypes.byref(got))
        if err == -1:
            raise ValueError(f"fused MLP needs {got.value} B of shared memory, more than this card's block may use")
        if err != 0:
            raise RuntimeError(f"fused_mlp_fwd launch plan failed: CUDA error {err}")
        _FWD_PLANS[key] = (lib, bucket, grid.value, got.value)
    return _FWD_PLANS[key]


def _bwd_plan(fw: FusedWeights, device):
    """(lib, bucket, regs, warps, grid, shared memory bytes) of the backward
    kernel: the register instantiation where it applies and fits, else the
    shared-memory one; raises when no block fits in shared memory."""
    key = (_dims(fw), device.index)
    if key not in _BWD_PLANS:
        lib = _bwd_library()
        bucket = mlp_bucket(fw)
        warps, grid, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        for regs in ((1, 0) if bwd_sums_in_registers(fw) else (0,)):
            with torch.cuda.device(device):
                err = lib.fused_mlp_bwd_plan(
                    bucket, regs, *_dims(fw), ctypes.byref(warps), ctypes.byref(grid), ctypes.byref(smem)
                )
            if err == 0:
                break
        if err == -1:
            raise ValueError(f"fused MLP backward needs {smem.value} B of shared memory, more than this card's block may use")
        if err != 0:
            raise RuntimeError(f"fused_mlp_bwd launch plan failed: CUDA error {err}")
        _BWD_PLANS[key] = (lib, bucket, regs, warps.value, grid.value, smem.value)
    return _BWD_PLANS[key]


def _check(x: torch.Tensor, name: str, cols: int, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name} must be (N, {cols}) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def _check_weights(fw: FusedWeights, device):
    if fw.packed.device != device or fw.packed.dtype != torch.bfloat16:
        raise ValueError("packed weights must be bf16 on the inputs' device")


def _aligned(x: torch.Tensor, cols: int) -> torch.Tensor:
    """x padded to `cols` columns, contiguous and 16-byte aligned (the
    kernels copy rows 16 bytes at a time)."""
    x = _pad_cols(x, cols).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fused_mlp_fwd_cuda(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """Launch the forward kernel on the current stream: (rgb (N, 3), dens (N, dd))."""
    device = enc.device
    _check(enc, "enc", fw.d_in_real, device)
    _check(sh, "sh", fw.d_sh_real, device)
    if sh.shape[0] != enc.shape[0]:
        raise ValueError("enc and sh must have the same number of rows")
    _check_weights(fw, device)
    lib, bucket, grid, smem = _fwd_plan(fw, device)
    n = enc.shape[0]
    rgb = torch.empty((n, RGB_OUT), dtype=torch.float32, device=device)
    dens = torch.empty((n, fw.dd), dtype=torch.float32, device=device)
    if n == 0:
        return rgb, dens[:, : fw.dd_real]
    x, s = _aligned(enc, fw.d_in), _aligned(sh, fw.d_sh)
    err = lib.fused_mlp_fwd(
        x.data_ptr(), s.data_ptr(), fw.packed.data_ptr(), rgb.data_ptr(), dens.data_ptr(),
        n, *_dims(fw), bucket, grid, smem, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: CUDA error {err}")
    profiling.count("launches.fused_mlp_fwd")
    return rgb, dens[:, : fw.dd_real]


def fused_mlp_fwd(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """(rgb_raw (N, 3), density_out (N, dd)): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if enc.device.type == "cuda":
        return fused_mlp_fwd_cuda(enc, sh, fw)
    if enc.device.type == "cpu":
        return fused_mlp_fwd_plain(enc, sh, fw)
    raise ValueError(f"fused_mlp_fwd runs on cuda or cpu tensors, got {enc.device}")


def fused_mlp_bwd_cuda(enc, sh, g_rgb, g_dens, fw: FusedWeights):
    """Launch the backward kernel (and its fixed-order reduction of the
    blocks' partial weight gradients) on the current stream."""
    device = enc.device
    n = enc.shape[0]
    _check(enc, "enc", fw.d_in_real, device)
    _check(sh, "sh", fw.d_sh_real, device)
    _check(g_rgb, "g_rgb", RGB_OUT, device)
    _check(g_dens, "g_dens", fw.dd_real, device)
    if not sh.shape[0] == g_rgb.shape[0] == g_dens.shape[0] == n:
        raise ValueError("enc, sh, g_rgb and g_dens must have the same number of rows")
    _check_weights(fw, device)
    lib, bucket, regs, warps, max_grid, smem = _bwd_plan(fw, device)
    w_elems = fw.packed.numel()
    d_enc = torch.empty((n, fw.d_in), dtype=torch.float32, device=device)
    grads = torch.empty((w_elems,), dtype=torch.float32, device=device)
    if n == 0:
        return d_enc[:, : fw.d_in_real], grads.zero_()
    rows = BWD_TILE_ROWS * warps
    grid = min(max_grid, -(-n // rows))
    partial = torch.empty((grid, w_elems), dtype=torch.float32, device=device)
    args = [_aligned(a, c) for a, c in ((enc, fw.d_in), (sh, fw.d_sh), (g_rgb, RGB_OUT), (g_dens, fw.dd))]
    err = lib.fused_mlp_bwd(
        *(a.data_ptr() for a in args), fw.packed.data_ptr(), d_enc.data_ptr(), partial.data_ptr(), grads.data_ptr(),
        n, *_dims(fw), bucket, regs, warps, grid, smem, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd launch failed: CUDA error {err}")
    profiling.count("launches.fused_mlp_bwd")
    return d_enc[:, : fw.d_in_real], grads


def fused_mlp_bwd(enc, sh, g_rgb, g_dens, fw: FusedWeights):
    """(d_enc, flat packed fp32 weight gradients): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if enc.device.type == "cuda":
        return fused_mlp_bwd_cuda(enc, sh, g_rgb, g_dens, fw)
    if enc.device.type == "cpu":
        return fused_mlp_bwd_plain(enc, sh, g_rgb, g_dens, fw)
    raise ValueError(f"fused_mlp_bwd runs on cuda or cpu tensors, got {enc.device}")


class _FusedHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, sh, nd, *weights):
        fw = pack_weights(weights[:nd], weights[nd:])
        ctx.save_for_backward(enc, sh)
        ctx.fw = fw
        return fused_mlp_fwd(enc, sh, fw)

    @staticmethod
    def backward(ctx, g_rgb, g_dens):
        enc, sh = ctx.saved_tensors
        fw = ctx.fw
        d_enc, flat = fused_mlp_bwd(enc, sh, g_rgb.contiguous(), g_dens.contiguous(), fw)
        dg, rg = unpack_grads(fw, flat)
        return (d_enc, None, None, *dg, *rg)


def fused_heads(enc: torch.Tensor, sh: torch.Tensor, dweights, rgb_weights):
    """Both heads through the fused kernels, differentiable in enc and the
    weights (not in sh): (rgb_raw (N, 3), density_out (N, dd)). rgb_weights
    is the unsplit list whose first matrix takes concat(dens, sh)."""
    return _FusedHeads.apply(enc, sh, len(dweights), *dweights, *rgb_weights)
