"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled, at first use, into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):
one nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
        -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu    (each)
    nvcc -shared -o build/torch_kernels/libmmr_kernels_<hash>.so *.o

Each compile's output (ptxas' registers, shared memory and spills per
kernel) is kept beside the library as `<name>_<hash>.log`.

The library goes to `build/torch_kernels/` at the root of the checkout
(listed in .gitignore), or where `set_build_dir` (the CLI's
`--compile-cache`) puts it, named by a hash of the sources and the flags: a
changed source is rebuilt, an unchanged one is loaded as it is. nvcc is
looked up in $CUDA_HOME/bin, then /usr/local/cuda/bin, then on PATH.

There is no fallback. Only the wrappers' CUDA branches call `load()`; on a
machine without nvcc it raises, and a wrapper given a CUDA tensor raises
with it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point: each pointer and the stream as c_void_p,
# so ctypes never truncates them to 32-bit ints
_SIGNATURES = {
    # x, out, groups, pixels, blocks, out_bf16, scale[3], offset[3], device,
    # stream
    "mmr_normalize_u8": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                         _F, _F, _F, _F, _F, _F, _I, _P],
    # y, a, b, out, B, H, W, C, is_bf16, vec, cc, th, tw, threads, blocks,
    # device, stream
    "mmr_stem_fwd": [_P] * 4 + [_I] * 12 + [_P],
    # g, y, a, b, dy, partial, dab, B, H, W, C, is_bf16, vec, cc, th, tw,
    # threads, blocks, device, stream
    "mmr_stem_bwd": [_P] * 7 + [_I] * 12 + [_P],
    # x, w, ab|null, y, partial, sums, M, K, N, relu, bm, bn, mgroups,
    # ksplit, device, stream
    "mmr_mm_stats": [_P] * 6 + [_I] * 9 + [_P],
    # gy, y, x, w, gs, ab|null, dx, dw, dab, ge, part_dw, part_ab, gsum_ab,
    # cnt, M, K, N, relu, splits, rows_per_split, bm, bn, tn, tk, device, stream
    "mmr_mm_stats_bwd": [_P] * 14 + [_I] * 11 + [_P],
    # x, w9, ab|null, y, partial, sums, B, H, W, C, Cout, relu, bm, nseg,
    # seg_rows, mgroups, ksplit, device, stream
    "mmr_c3_fwd": [_P] * 6 + [_I] * 12 + [_P],
    # gy, y, x, w9, gs, ab|null, dx, dw9, dab, ge, part_dw, part_ab, gsum_ab,
    # cnt, B, H, W, C, Cout, relu, splits, rows_per_split, bm, nseg, seg_rows,
    # device, stream
    "mmr_c3_bwd": [_P] * 14 + [_I] * 12 + [_P],
    # y, centers, out, N, D, K, blocks, tiles, smem, device, stream
    "mmr_assign": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_longlong,
                   _I, _I, _P],
    # rows (5 int64 a tensor), tensors, mu_bf16, 1 - b1, b1, b2, 1 - b2, eps,
    # step (device float[3]: -lr, 1 / bc1, 1 / bc2), sms, launched (int*),
    # device, stream
    "mmr_adam": [_P, _I, _I] + [_F] * 5 + [_P, _I, _P, _I, _P],
}


def set_build_dir(path: str | Path) -> None:
    """Build (and look for) the kernel library in `path` from now on; a
    library this process has loaded already stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
            "port's CUDA kernels are compiled on first use on a machine with "
            "the CUDA toolkit"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmmr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    digest = out.stem.rsplit("_", 1)[1]
    srcs = sources()
    objects = [BUILD_DIR / f"{src.stem}_{digest}.{os.getpid()}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objects)]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    try:
        for src, cmd, proc in zip(srcs, cmds, procs):
            log = proc.communicate()[0]
            (BUILD_DIR / f"{src.stem}_{digest}.log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{log}"
                )
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {res.returncode}:\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    finally:
        for proc in procs:  # a failed compile leaves no sibling running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mmr_error_string.argtypes = [ctypes.c_int]
    lib.mmr_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().mmr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a launch on t's device."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
