"""The plan interpreter: one launch evaluates the range plan's op stream over
one chunk of the register files (``risc0_tpu_torch/csrc/eval_plan.cu``).

Its plain twin is ``circuit/ir_range._run_chunk``, which runs the same
plan as torch op groups; ``make_eval_check`` takes the twin for a file on
the CPU and this kernel for one on the card.  ``eval_plan`` launches the
kernel or raises.  ``eval_plan.launches`` counts its launches (one a
chunk).
"""

from __future__ import annotations

import torch

from . import build


def eval_plan(ops, head, fp, ext, pm):
    """Evaluate every group of the op stream `ops` (int32, on the card;
    `head` its header, ``ir_range.encode_plan``) over the chunk whose
    inputs are staged in `fp` (fp_rows, T) and `ext` (ext_rows, T, 4),
    in place, with the mix powers `pm` (n, 4).  All int32 words on one
    CUDA device; launches on its current stream and does not wait."""
    fp_rows, ext_rows, mixes, _groups = head
    for name, x in (("ops", ops), ("fp", fp), ("ext", ext), ("pm", pm)):
        if x.device.type != "cuda":
            raise ValueError(f"eval_plan: {name} must lie on the card, "
                             f"got {x.device}")
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"eval_plan: {name} must be contiguous int32, "
                             f"got {x.dtype}")
        if x.device != fp.device:
            raise ValueError(f"eval_plan: {name} on {x.device}, fp on "
                             f"{fp.device}")
    T = fp.shape[1] if fp.dim() == 2 else -1
    if (fp.dim() != 2 or fp.shape[0] < fp_rows or ext.dim() != 3
            or ext.shape[0] < ext_rows or ext.shape[1:] != (T, 4)
            or pm.dim() != 2 or pm.shape[0] < mixes or pm.shape[1] != 4
            or ops.dim() != 1):
        raise ValueError(
            f"eval_plan: the stream needs fp ({fp_rows}, T), ext "
            f"({ext_rows}, T, 4) and pm ({mixes}, 4); got {tuple(fp.shape)}, "
            f"{tuple(ext.shape)}, {tuple(pm.shape)}")
    if ext.data_ptr() % 16 or pm.data_ptr() % 16:
        raise ValueError("eval_plan: ext and pm must be 16-byte aligned")
    build.check(build.library().eval_plan(
        ops.data_ptr(), ops.numel(), fp.data_ptr(), ext.data_ptr(),
        pm.data_ptr(), T, torch.cuda.current_stream(fp.device).cuda_stream),
        "eval_plan")
    eval_plan.launches += 1


eval_plan.launches = 0
