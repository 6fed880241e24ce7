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
`fused_heads` wraps the pair in a torch.autograd.Function.
"""

import ctypes
import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.ops.mlp import bf16_round

# launches of each CUDA kernel in this process (a wrapper adds one per launch)
N_LAUNCHES = 0  # fused_mlp_fwd
N_LAUNCHES_BWD = 0  # fused_mlp_bwd

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use
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
    bf16 buffer in the kernel's order (csrc/fused_mlp_fwd.cu header)."""

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
def _fwd_library():
    lib = kernels.library("fused_mlp_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.fused_mlp_fwd.restype = i
    lib.fused_mlp_fwd_smem_bytes.argtypes = [i] * 7
    lib.fused_mlp_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_library():
    lib = kernels.library("fused_mlp_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.fused_mlp_bwd.restype = i
    lib.fused_mlp_bwd_smem_bytes.argtypes = [i] * 8
    lib.fused_mlp_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_mlp_bwd_grid.argtypes = [i] * 9 + [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_bwd_grid.restype = i
    return lib


def _check(x: torch.Tensor, name: str, cols: int, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name} must be (N, {cols}) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def _check_weights(fw: FusedWeights, device):
    if fw.packed.device != device or fw.packed.dtype != torch.bfloat16:
        raise ValueError("packed weights must be bf16 on the inputs' device")


def fused_mlp_fwd_cuda(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """Launch the forward kernel on the current stream: (rgb (N, 3), dens (N, dd))."""
    global N_LAUNCHES
    device = enc.device
    _check(enc, "enc", fw.d_in_real, device)
    _check(sh, "sh", fw.d_sh_real, device)
    if sh.shape[0] != enc.shape[0]:
        raise ValueError("enc and sh must have the same number of rows")
    _check_weights(fw, device)
    lib = _fwd_library()
    smem = lib.fused_mlp_fwd_smem_bytes(fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused MLP needs {smem} B of shared memory, more than {MAX_SMEM_BYTES}")
    n = enc.shape[0]
    x = _pad_cols(enc, fw.d_in).contiguous()
    s = _pad_cols(sh, fw.d_sh).contiguous()
    rgb = torch.empty((n, RGB_OUT), dtype=torch.float32, device=device)
    dens = torch.empty((n, fw.dd), dtype=torch.float32, device=device)
    if n == 0:
        return rgb, dens[:, : fw.dd_real]
    err = lib.fused_mlp_fwd(
        x.data_ptr(), s.data_ptr(), fw.packed.data_ptr(), rgb.data_ptr(), dens.data_ptr(),
        n, fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: CUDA error {err}")
    N_LAUNCHES += 1
    return rgb, dens[:, : fw.dd_real]


def fused_mlp_fwd(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """(rgb_raw (N, 3), density_out (N, dd)): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if enc.device.type == "cuda":
        return fused_mlp_fwd_cuda(enc, sh, fw)
    if enc.device.type == "cpu":
        return fused_mlp_fwd_plain(enc, sh, fw)
    raise ValueError(f"fused_mlp_fwd runs on cuda or cpu tensors, got {enc.device}")


def bwd_warps(fw: FusedWeights) -> int:
    """Warps per block the backward kernel takes for these widths: the most
    rows per block (16 per warp, up to 8 warps) that fit in shared memory;
    raises when even one warp's tile does not fit."""
    lib = _bwd_library()
    for warps in (8, 4, 2, 1):
        smem = lib.fused_mlp_bwd_smem_bytes(fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr, warps)
        if smem <= MAX_SMEM_BYTES:
            return warps
    raise ValueError(f"fused MLP backward needs {smem} B of shared memory at 16 rows, more than {MAX_SMEM_BYTES}")


def fused_mlp_bwd_cuda(enc, sh, g_rgb, g_dens, fw: FusedWeights):
    """Launch the backward kernel (and its fixed-order reduction of the
    blocks' partial weight gradients) on the current stream."""
    global N_LAUNCHES_BWD
    device = enc.device
    n = enc.shape[0]
    _check(enc, "enc", fw.d_in_real, device)
    _check(sh, "sh", fw.d_sh_real, device)
    _check(g_rgb, "g_rgb", RGB_OUT, device)
    _check(g_dens, "g_dens", fw.dd_real, device)
    if not sh.shape[0] == g_rgb.shape[0] == g_dens.shape[0] == n:
        raise ValueError("enc, sh, g_rgb and g_dens must have the same number of rows")
    _check_weights(fw, device)
    lib = _bwd_library()
    warps = bwd_warps(fw)
    w_elems = fw.packed.numel()
    d_enc = torch.empty((n, fw.d_in), dtype=torch.float32, device=device)
    grads = torch.empty((w_elems,), dtype=torch.float32, device=device)
    if n == 0:
        return d_enc[:, : fw.d_in_real], grads.zero_()
    grid = ctypes.c_int(0)
    err = lib.fused_mlp_bwd_grid(n, fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr, warps, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd occupancy query failed: CUDA error {err}")
    partial = torch.empty((grid.value, w_elems), dtype=torch.float32, device=device)
    args = [_pad_cols(a, c).contiguous() for a, c in ((enc, fw.d_in), (sh, fw.d_sh), (g_rgb, RGB_OUT), (g_dens, fw.dd))]
    err = lib.fused_mlp_bwd(
        *(a.data_ptr() for a in args), fw.packed.data_ptr(), d_enc.data_ptr(), partial.data_ptr(), grads.data_ptr(),
        n, fw.d_in, fw.d_sh, fw.wd, fw.wr, fw.dd, fw.nd, fw.nr, warps, grid.value,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd launch failed: CUDA error {err}")
    N_LAUNCHES_BWD += 1
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
