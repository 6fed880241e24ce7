"""Fused forward of both NGP MLP heads: a CUDA kernel for Hopper + its plain version.

Counterpart: ngp_tpu/ops/fused_mlp.py:57-68 (supports), :91-104
(_fwd_kernel, the Pallas kernel this replaces), :185-207 (_fused_fwd_impl)
and :249-252 (split_first_rgb). Differs: the kernel is CUDA C++ for sm_90a
(csrc/fused_mlp_fwd.cu), built with nvcc at first use into
build/ngp_tpu_torch/ and bound through ctypes; it is the CUDA path of
NGPModel.rgbsigma_raw whenever `supports()` holds, with no opt-in switch
(the per-pallas_call dispatch tax that made the TPU kernel opt-in does not
exist here). The backward (_bwd_kernel) is not ported yet. The ragged last
row tile is masked inside the kernel instead of padding N in the wrapper.

`fused_mlp_fwd` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no other fallback.
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ngp_tpu_torch.ops.mlp import bf16_round

# launches of the CUDA kernel in this process (the wrapper adds one per launch)
N_LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_mlp_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ngp_tpu_torch"
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


# ----------------------------------------------------------------- the kernel
_LIB = None
BUILD_LOG = ""  # nvcc / ptxas output of the build this process loaded


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused MLP kernel is built with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/fused_mlp_fwd.cu for sm_90a into build/ngp_tpu_torch/ (once
    per source content) and return the shared library's path."""
    global BUILD_LOG
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libfused_mlp_fwd_{hashlib.sha1(src).hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    BUILD_LOG = proc.stderr
    os.replace(tmp, so)
    return so


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.fused_mlp_fwd.restype = i
        lib.fused_mlp_fwd_smem_bytes.argtypes = [i] * 7
        lib.fused_mlp_fwd_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, name: str, cols: int, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name} must be (N, {cols}) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def fused_mlp_fwd_cuda(enc: torch.Tensor, sh: torch.Tensor, fw: FusedWeights):
    """Launch the kernel on the current stream: (rgb (N, 3), dens (N, dd))."""
    global N_LAUNCHES
    device = enc.device
    _check(enc, "enc", fw.d_in_real, device)
    _check(sh, "sh", fw.d_sh_real, device)
    if sh.shape[0] != enc.shape[0]:
        raise ValueError("enc and sh must have the same number of rows")
    if fw.packed.device != device or fw.packed.dtype != torch.bfloat16:
        raise ValueError("packed weights must be bf16 on the inputs' device")
    lib = _library()
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
