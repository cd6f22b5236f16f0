"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
libraries land in ``kernels/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. All missing libraries are built
together, one ``nvcc`` process per source. Nothing here runs at import
time; the first kernel launch triggers :func:`load`.

The flags never include ``--use_fast_math``: the int8 quantizer's codes
depend on a correctly rounded division.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

#: source stem -> (C entry point, argtypes); every entry returns the
#: launch's cudaGetLastError() as an int
SIGNATURES = {
    "paged_decode": ("paged_decode_attention",
                     [_I, _I] + [_P] * 8 + [_I] * 7 + [_F, _P]),
    "paged_prefill": ("paged_prefill_attention",
                      [_I, _I] + [_P] * 9 + [_I] * 10 + [_F, _P]),
    "paged_decode_tma": ("paged_decode_attention_tma",
                         [_I] + [_P] * 14 + [_I] + [_L] * 4 + [_I] * 8
                         + [_F, _P]),
    "paged_decode_tma128": ("paged_decode_attention_tma128",
                            [_I] + [_P] * 14 + [_I] + [_L] * 4 + [_I] * 8
                            + [_F, _P]),
    "paged_prefill_tc": ("paged_prefill_attention_tc",
                         [_I] + [_P] * 11 + [_I] * 12 + [_F, _P]),
    "paged_prefill_tc128": ("paged_prefill_attention_tc128",
                            [_I] + [_P] * 11 + [_I] * 12 + [_F, _P]),
    "quantize": ("quantize_int8", [_P] * 4 + [_I, _P]),
    "dequantize": ("dequantize_int8", [_P] * 3 + [_I, _P]),
    "flash_fwd": ("flash_attention_fwd",
                  [_I] + [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P]),
    "flash_fwd_tc": ("flash_attention_fwd_tc",
                     [_P] * 5 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_fwd_tc128": ("flash_attention_fwd_tc128",
                        [_P] * 5 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_fwd_tf32": ("flash_attention_fwd_tf32",
                       [_P] * 5 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_preprocess": ("flash_attention_bwd_preprocess",
                             [_I] + [_P] * 3 + [_I, _I, _P]),
    "flash_bwd_preprocess_vec": ("flash_attention_bwd_preprocess_vec",
                                 [_I] + [_P] * 3 + [_L, _I, _P]),
    "flash_bwd_dkv": ("flash_attention_bwd_dkv",
                      [_I] + [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dkv_tc": ("flash_attention_bwd_dkv_tc",
                         [_P] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dkv_tc128": ("flash_attention_bwd_dkv_tc128",
                            [_P] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dkv_tf32": ("flash_attention_bwd_dkv_tf32",
                           [_P] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dq": ("flash_attention_bwd_dq",
                     [_I] + [_P] * 7 + [_I] * 8 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dq_tc": ("flash_attention_bwd_dq_tc",
                        [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dq_tc128": ("flash_attention_bwd_dq_tc128",
                           [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "flash_bwd_dq_tf32": ("flash_attention_bwd_dq_tf32",
                          [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P]),
    "lora_matmul": ("lora_matmul", [_I] + [_P] * 5 + [_I] * 10 + [_F, _P]),
    "lora_matmul_tc": ("lora_matmul_tc",
                       [_P] * 5 + [_I] * 10 + [_F, _P]),
    "mlstm_chunked": ("mlstm_chunked",
                      [_I] + [_P] * 12 + [_I] * 4 + [_P] * 5 + [_P, _P]),
    "mlstm_chunked_tc": ("mlstm_chunked_tc",
                         [_I] + [_P] * 12 + [_I] * 4 + [_P, _P]),
    "mlstm_chunked_tc_save": ("mlstm_chunked_tc_save",
                              [_I] + [_P] * 12 + [_I] * 4 + [_P] * 5
                              + [_P, _P]),
    "mlstm_chunked_bwd": ("mlstm_chunked_bwd",
                          [_I] + [_P] * 19 + [_I] * 4 + [_P]),
    "mlstm_chunked_bwd_tc": ("mlstm_chunked_bwd_tc",
                             [_I] + [_P] * 20 + [_I] * 4 + [_P, _P]),
    "kv_append_int8": ("kv_append_int8",
                       [_I] + [_P] * 9 + [_I] + [_L] * 4 + [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_entries: Dict[str, ctypes._CFuncPtr] = {}
#: stem -> {"seconds": nvcc wall time (0.0 when reused), "log": ptxas report}
build_report: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "hand-written kernels need nvcc to build")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel library that is missing, all ``nvcc``
    processes at once; raise with the compiler's output if one fails.
    Returns :data:`build_report`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for stem in SIGNATURES:
        out = _library_path(stem)
        if out.exists():
            build_report.setdefault(stem, {"seconds": 0.0, "log": "",
                                           "path": str(out)})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        build_report[stem] = {"seconds": time.perf_counter() - t0,
                              "log": log, "path": str(out)}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_report


def load(stem: str) -> ctypes._CFuncPtr:
    """The bound C entry point of kernel library ``stem``, building the
    libraries first if needed."""
    fn = _entries.get(stem)
    if fn is not None:
        return fn
    with _lock:
        fn = _entries.get(stem)
        if fn is None:
            build_all()
            name, argtypes = SIGNATURES[stem]
            fn = getattr(ctypes.CDLL(str(_library_path(stem))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[stem] = fn
        return fn
