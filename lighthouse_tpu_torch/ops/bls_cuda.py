"""Loader and launch helpers for the BLS12-381 CUDA kernels
(``csrc/bls12_381.cu``, field and tower in ``csrc/bls12_381.cuh``) and the
Fr kernels of KZG (``csrc/kzg.cu`` over ``csrc/fr.cuh``).

The kernel wrappers live beside their plain versions in the modules of
their JAX counterparts: on the batch-verify path
``bls_backend.pipeline_device`` and ``bls_backend.g2_subgroup_device``,
``msm.blinded_fold_device`` and ``dispatch_pipeline.fq12_mul_device``; on
the attestation ingest path ``msm.gather_fold_device``; on the trusted-setup
load ``bls_backend.g1_subgroup_device``; on the final exponentiation's
device route ``bls12_381.final_exp_hard_device``; on the KZG path
``fr.fr_to_mont_device``, ``fr.eval_device``,
``msm.fold_device``, ``bls12_381.miller_reduce_device`` and
``kzg.kzg_fused_device``.
Each checks its tensors here, launches on the current CUDA stream, raises
on a launch error, and counts its CUDA launches on its ``launches``
attribute.  The library is built by nvcc at first use, never at import;
the tapes of its group kernels (``csrc/bls12_381.cuh``) are built on the
host by ``csrc/bls_tapes.cc`` (g++), the code the CPU tests run, and handed
to it as it loads.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lighthouse_tpu_torch.native import build_cuda_lib, build_host_lib
from lighthouse_tpu_torch.ops import modinv
from lighthouse_tpu_torch.ops.bigint import P_INT

# C launchers: (pointer arguments, integer arguments) per function of each
# library; each takes the stream last and returns a cudaError_t code
_SIGNATURES = {
    "bls12_381": {                            # csrc/bls12_381.cu
        "lh_gj_scalar_mul": (11, 2),
        "lh_g1_scalar_mul": (6, 2),
        "lh_g1_add_halves": (3, 1),
        "lh_g2_add_halves": (3, 1),
        "lh_miller": (8, 3),
        "lh_fq12_mul_halves": (1, 1),
        "lh_fq12_mul": (3, 1),
        "lh_g2_subgroup": (3, 1),
        "lh_blinded_final": (8, 2),
        "lh_g1_gather_scalar_mul": (7, 2),
        "lh_g1_affine": (6, 1),
        "lh_g1_subgroup": (3, 1),
        "lh_final_exp_hard": (2, 1),
        "lh_fp_mul_chain": (4, 2),
    },
    "kzg": {                                  # csrc/kzg.cu
        "lh_fr_to_mont": (2, 1),
        "lh_fr_eval": (5, 3),
        "lh_fr_eval_occupancy": (1, 2),
    },
}

# --------------------------------------------------------------------------
# Fp multiplications, counted from csrc/bls12_381.cuh on this run's data (a
# CPU test compiles the lane code with a counter and checks every figure
# here).  The kernels do only the products the function needs: no doubling
# or add of infinity, no product by a factor of one, and the Miller and ψ
# add steps only on set bits of |x|.  Each is one 12-word CIOS Montgomery
# multiply of 2·12² + 12 = 300 32-bit multiply-adds.
# --------------------------------------------------------------------------

IMADS_PER_FP_MUL = 2 * 12 ** 2 + 12
FP2_MUL = 3                                   # Karatsuba
FP6_MUL = 6 * FP2_MUL                         # Karatsuba
FP12_MUL = 3 * FP6_MUL                        # Karatsuba over w
FP12_SQR = 2 * FP6_MUL                        # complex squaring
LINE_MUL = 13 * FP2_MUL                       # f times a sparse line
JAC_DOUBLE = 7                                # per coordinate field multiply
JAC_ADD = 16
WINDOW_TABLE = 7 * JAC_DOUBLE + 7 * JAC_ADD   # entries 2..15

_X = 0xD201000000010000
_X_ADDS = bin(_X).count("1") - 1              # set bits below the top one
MILLER_DBL = 11 * FP2_MUL + 3 * 2 + FP12_SQR + LINE_MUL
MILLER_ADD = 19 * FP2_MUL + LINE_MUL
MILLER_LANE = 17 + 63 * MILLER_DBL + _X_ADDS * MILLER_ADD
PSI_LANE = (63 * JAC_DOUBLE + _X_ADDS * 11 + 5) * FP2_MUL + 2
FP_INV = 381 + bin(P_INT - 2).count("1")
# row 12's sigma test, [z^2]P as two scans over |z|: 63 doublings each, a
# mixed add (11 products) on each set bit below the top one in the first
# and a full add in the second, then the tail's 8 (beta x, the residues'
# 4, the curve's 3)
JAC_MADD = 11
G1_SUBGROUP_LANE = 2 * 63 * JAC_DOUBLE + _X_ADDS * (JAC_MADD + JAC_ADD) + 8


# row 9, one lane: five x-ladders (63 cyclotomic squares of 9 Fp2 squares
# of 2 products, a product on each of the 5 set bits below the top one),
# the cyclotomic squares of m^x and m, 8 more Fq12 products, and 1 + 2 + 3
# Frobenius rounds of 5 Fp2 products
FP2_SQR = 2
CYC_SQR = 9 * FP2_SQR
CYC_EXP_X = 63 * CYC_SQR + _X_ADDS * FP12_MUL
FROBENIUS_ROUND = 5 * FP2_MUL
FINAL_EXP_HARD_LANE = 5 * CYC_EXP_X + 2 * CYC_SQR + 8 * FP12_MUL + 6 * FROBENIUS_ROUND

# the tapes a group lane of rows 9 and 6 runs, and how often (a CPU test
# holds their products to FINAL_EXP_HARD_LANE and PSI_LANE); with the lane's
# other levels (loads, copies, conjugations, the verdict), one row each
FINAL_EXP_HARD_TAPES = {"cyc_sqr": 5 * 63 + 2, "fq12_mul": 5 * _X_ADDS + 8, "frob1": 1,
                        "frob2": 1, "frob3": 1}
FINAL_EXP_HARD_OTHER_LEVELS = 1 + 5 * 2 + 2 + 1
PSI_TAPES = {"psi_dbl": 63, "psi_add": _X_ADDS, "psi_tail": 1}
PSI_OTHER_LEVELS = 3
# row 12's lane: the loads, the two scans' top-bit loads, the copy of T1,
# the verdict
G1_SUBGROUP_TAPES = {"gs_dbl": 126, "gs_madd": _X_ADDS, "gs_add": _X_ADDS, "gs_tail": 1}
G1_SUBGROUP_OTHER_LEVELS = 5


def _track_fp_muls(digits: np.ndarray) -> np.ndarray:
    """Per lane, the field products of one windowed scalar-mul track over
    MSB-first digits [n_digits, n]: for a nonzero scalar the window table,
    then four doublings per digit after the first nonzero one and an add per
    later nonzero digit."""
    nz = np.asarray(digits) != 0
    live = nz.any(axis=0)
    first = np.argmax(nz, axis=0)
    later = np.arange(nz.shape[0])[:, None] > first[None, :]
    return (WINDOW_TABLE * live + 4 * JAC_DOUBLE * (later & live).sum(axis=0)
            + JAC_ADD * (later & nz).sum(axis=0))


def scalar_mul_fp_muls(digits: np.ndarray) -> int:
    """G1 and G2 windowed scalar muls over MSB-first digits [16, n] (the G2
    products are Fp2)."""
    return int(_track_fp_muls(digits).sum()) * (1 + FP2_MUL)


def g1_scalar_mul_fp_muls(digits: np.ndarray) -> int:
    """``lh_g1_scalar_mul`` over MSB-first digits [n_digits, n]."""
    return int(_track_fp_muls(digits).sum())


def tree_products(live: np.ndarray, stop: int = 1) -> tuple[int, np.ndarray]:
    """Products of a tree that combines rows i and i + half until ``stop``
    rows remain, where only two live rows cost one -> (count, live rows
    left)."""
    live = np.asarray(live, bool)
    count = 0
    half = live.shape[0] // 2
    while half >= max(stop, 1):
        a, b = live[:half], live[half:2 * half]
        count += int((a & b).sum())
        live = a | b
        half //= 2
    return count, live


def pipeline_fp_muls(digits: np.ndarray, n_groups: int, lane_mask: np.ndarray) -> int:
    """One ``lh_bls_pipeline`` call at digits [16, n] and Miller lane mask
    [m]: the scalar muls, the G1 segment fold (n_groups > 0), the G2 tree
    sum, the unmasked Miller lanes plus the Σ r·sig lane, and the product
    tree over the lanes that are not one."""
    live = np.asarray(digits).any(axis=0)
    fold = tree_products(live, n_groups)[0] * JAC_ADD if n_groups else 0
    g2 = tree_products(live)[0] * JAC_ADD * FP2_MUL
    not_one = np.append(np.asarray(lane_mask, bool), live.any())
    n_out = 1 << (not_one.shape[0] - 1).bit_length()       # the tree's pow2 lanes
    not_one = np.append(not_one, np.zeros(n_out - not_one.shape[0], bool))
    return (scalar_mul_fp_muls(digits) + fold + g2 + int(not_one.sum()) * MILLER_LANE
            + tree_products(not_one)[0] * FP12_MUL)


def blinded_fold_fp_muls(live: np.ndarray, n_segments: int) -> int:
    """The Fp products of ``msm.blinded_fold_device`` over lanes whose
    Z != 0 is ``live``: the tree's adds of two live rows (launches and
    tail alike), then per segment the add of the blinding total (a live
    segment) and the 4 affine products.  The inversions are counted apart
    (``fp_inv_muladds``)."""
    adds, seg_live = tree_products(live, n_segments)
    return (adds + int(seg_live.sum())) * JAC_ADD + 4 * n_segments


def fp_inv_muladds(z_rows: np.ndarray) -> int:
    """Multiply-adds of ``fp_inv_var`` (csrc/bls12_381.cuh) on Montgomery
    word rows [n, 12]: the divsteps on each row's value (``modinv``), then
    the product by R^3."""
    rows = np.ascontiguousarray(np.asarray(z_rows, np.uint32).reshape(-1, 12))
    return sum(modinv.inverse(int.from_bytes(r.astype("<u4").tobytes(), "little"), P_INT)[1]
               + IMADS_PER_FP_MUL for r in rows)


def blinded_fold_muladds(live: np.ndarray, z_rows: np.ndarray) -> int:
    """32-bit multiply-adds of ``msm.blinded_fold_device``: its Fp products
    and, per segment, the inversion of the Z that ``z_rows`` (the plain
    sums', ``msm.blinded_sum_plain``) holds."""
    return (blinded_fold_fp_muls(live, len(z_rows)) * IMADS_PER_FP_MUL
            + fp_inv_muladds(z_rows))


def g1_fold_fp_muls(digits: np.ndarray, n_segments: int) -> int:
    """``msm.fold_device``: the G1 scalar muls, then the s-major tree down
    to ``n_segments`` rows, where only adds of two live rows cost."""
    live = np.asarray(digits).any(axis=0)
    return g1_scalar_mul_fp_muls(digits) + tree_products(live, n_segments)[0] * JAC_ADD


def gather_fold_fp_muls(digits: np.ndarray, n_segments: int) -> int:
    """``msm.gather_fold_device``: the G1 fold of the gathered lanes, then
    per segment the Fermat inversion and the 4 affine products."""
    return g1_fold_fp_muls(digits, n_segments) + n_segments * (FP_INV + 4)


def miller_reduce_fp_muls(live: np.ndarray) -> int:
    """Miller lanes whose flag ``live`` is set ([n_out], the padding false),
    then the product tree over them (a factor of one costs nothing)."""
    live = np.asarray(live, bool)
    return int(live.sum()) * MILLER_LANE + tree_products(live)[0] * FP12_MUL


def tapes_lib() -> ctypes.CDLL:
    """The host library of the group kernels' tapes (``csrc/bls_tapes.cc``),
    built at first use, with its argument types set."""
    h = build_host_lib("bls_tapes")
    h.lh_tapes_size.restype = ctypes.c_longlong
    h.lh_build_tapes.argtypes = [ctypes.c_void_p]
    h.lh_build_tapes.restype = ctypes.c_int
    h.lh_tape_stats.argtypes = [ctypes.c_void_p]
    h.lh_tape_stats.restype = None
    return h


TAPE_NAMES = ("miller_setup", "miller_dbl", "miller_add", "g1_dbl", "g1_add", "g2_add",
              "g1g2_dbl", "g1g2_add", "fq12_mul", "cyc_sqr", "frob1", "frob2", "frob3",
              "psi_dbl", "psi_add", "psi_tail", "gs_dbl", "gs_madd", "gs_add", "gs_tail")
GROUP_KERNELS = ("k_gj_scalar_mul", "k_g1_scalar_mul", "k_miller", "k_fq12_mul",
                 "k_final_exp_hard", "k_g2_subgroup", "k_g1_subgroup")
GROUP_TAPES = {"k_gj_scalar_mul": TAPE_NAMES[4:8], "k_g1_scalar_mul": TAPE_NAMES[3:5],
               "k_miller": TAPE_NAMES[0:3], "k_fq12_mul": TAPE_NAMES[8:9],
               "k_final_exp_hard": TAPE_NAMES[8:13], "k_g2_subgroup": TAPE_NAMES[13:16],
               "k_g1_subgroup": TAPE_NAMES[16:20]}


def lane_shape(stats: dict, plan: dict, other_levels: int) -> dict:
    """A group lane's levels, product rounds and rows (``tape_stats`` rows),
    from the tapes it runs (``plan``: tape -> runs) and its other levels."""
    shape = {k: sum(stats["tapes"][t][k] * n for t, n in plan.items())
             for k in ("levels", "rounds", "rows", "products")}
    shape["levels"] += other_levels
    shape["rows"] += other_levels
    return shape


def tape_stats() -> dict:
    """Per tape its levels, temporaries, products, rounds (a level's
    products over its group's width, rounded up), positions (operations
    and fillers, 8 bytes each) and rows (the operations a level's busiest
    thread runs in turn, summed over the levels); per group kernel its
    lane's workspace (Fp slots), group width and the tapes it stages in
    shared memory."""
    n, k = len(TAPE_NAMES), len(GROUP_KERNELS)
    out = (ctypes.c_int * (3 + 6 * n + 2 * k))()
    tapes_lib().lh_tape_stats(out)
    if out[0]:
        raise RuntimeError("the group kernels' tapes did not build")
    tapes = {name: dict(zip(("levels", "temps", "products", "rounds", "positions", "rows"),
                            out[3 + 6 * i:9 + 6 * i]))
             for i, name in enumerate(TAPE_NAMES)}
    more = out[3 + 6 * n:]
    kernels = {name: {"workspace_slots": more[i], "width": more[k + i],
                      "tapes": GROUP_TAPES[name]}
               for i, name in enumerate(GROUP_KERNELS)}
    return {"tapes": tapes, "kernels": kernels}


def lib(name: str = "bls12_381") -> ctypes.CDLL:
    """The CUDA library ``csrc/<name>.cu``, built at first use, with its
    launchers' argument types set (and, for ``bls12_381``, its tapes)."""
    h = build_cuda_lib(name)
    if h.lh_error_string.restype is not ctypes.c_char_p:
        for fn_name, (n_ptr, n_int) in _SIGNATURES[name].items():
            fn = getattr(h, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        h.lh_error_string.argtypes = [ctypes.c_int]
        if name == "bls12_381":
            t = tapes_lib()
            blob = ctypes.create_string_buffer(t.lh_tapes_size())
            if t.lh_build_tapes(blob) != 0:
                raise RuntimeError("the group kernels' tapes did not build")
            h.lh_set_tapes.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
            h.lh_set_tapes.restype = ctypes.c_int
            if h.lh_set_tapes(blob, len(blob)) != 0:
                raise RuntimeError("lh_set_tapes refused the tapes (a layout mismatch)")
        h.lh_error_string.restype = ctypes.c_char_p
    return h


def launch(name: str, *args, library: str = "bls12_381") -> None:
    """Call the C launcher ``name`` of ``library`` with tensor pointers and
    ints, on the current stream of the first tensor's device; raise on a
    CUDA error."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        h = lib(library)
        rc = getattr(h, name)(*vals, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {h.lh_error_string(rc).decode()}")


def check(x: torch.Tensor, tail: tuple, name: str, dtype=torch.int32) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on the CPU or a
    CUDA device whose trailing shape is ``tail``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape[x.dim() - len(tail):]) != tuple(tail) or x.dim() < len(tail):
        raise ValueError(f"{name}: expected trailing shape {tail}, got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def same_device(name: str, *xs: torch.Tensor) -> torch.device:
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    return devs.pop()
