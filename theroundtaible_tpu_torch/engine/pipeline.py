"""Pipeline parallelism - GPipe-style microbatched prefill over a "pipe"
mesh axis (counterpart of theroundtaible_tpu/engine/pipeline.py).

Layers split into contiguous stages, one per rank of the pipe axis (a
stage's ranks under TP inside stages, sharding.PipeMesh); each rank holds
only its stage's weights (models/common.Stage: init_params or
weights.params_from_numpy with `stage=`). Microbatches flow stage to
stage: stage s works on microbatch m once stage s-1 has sent it, its own
send of m runs asynchronously while it starts m+1 (distributed.send_to),
and the last stage applies the final norm and the head. Where the JAX
package's SPMD program keeps every stage computing every step of the
(n_stages + n_micro - 1)-step schedule and masks the bubbles, a process
here simply waits for its input (no masked bubble compute).

`make_pp_prefill` is the full-sequence prefill (logits [B, T, V]);
`run_microbatches` is the schedule itself, which the serving engine's
prefill chunks run too (engine/pp_serving.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .distributed import broadcast_from, recv_into, send_to
from .models.common import ModelConfig, Params, forward
from .sharding import PipeMesh, build_pipe_mesh  # noqa: F401 - JAX's name


def run_microbatches(mesh: PipeMesh, n_micro: int,
                     stage_fn: Callable[[int, Optional[torch.Tensor]],
                                        torch.Tensor],
                     hidden_shape: Callable[[int], tuple],
                     dtype, device) -> list[torch.Tensor]:
    """One pass of the GPipe schedule on this rank: for each microbatch m
    in order, the input (None on the first stage, else the previous
    stage's hidden states [mb, T, E] of shape hidden_shape(m), received
    into a fresh buffer), then `stage_fn(m, input)`; a stage other than
    the last sends its output to the next stage without waiting, and
    every send is waited for before this returns. Returns the last
    stage's outputs in microbatch order ([] on the other stages)."""
    pending, banked = [], []
    try:
        for m in range(n_micro):
            x = None
            if not mesh.first:
                x = recv_into(torch.empty(hidden_shape(m), dtype=dtype,
                                          device=device),
                              mesh.rank_of(mesh.stage - 1), mesh.pipe_group)
            out = stage_fn(m, x)
            if mesh.last:
                banked.append(out)
            else:
                pending.append(send_to(out, mesh.rank_of(mesh.stage + 1),
                                       mesh.pipe_group))
    finally:
        for p in pending:
            p.wait()
    return banked


def stage_dtype(params: Params):
    """The activations' dtype of a stage's weights (its norms')."""
    return params["layers"][0]["input_norm"].dtype


def make_pp_prefill(cfg: ModelConfig, mesh: PipeMesh, n_micro: int):
    """fn(params, tokens [B,T], positions [B,T], valid [B]) -> f32 logits
    [B,T,V] on every rank, `params` this rank's stage of the weights. B
    must divide into n_micro microbatches; the layers into the mesh's
    stages (JAX's messages)."""
    if cfg.num_layers % mesh.stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers do not split into {mesh.stages} "
            f"stages")

    def call(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        if b % n_micro != 0:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches")
        mb = b // n_micro

        def stage_fn(m, x):
            rows = slice(m * mb, (m + 1) * mb)
            out, _ = forward(params, cfg, tokens[rows], positions[rows],
                             None, None, valid[rows], mesh=mesh.stage_mesh,
                             hidden=x, head=mesh.last)
            return out

        banked = run_microbatches(mesh, n_micro, stage_fn,
                                  lambda m: (mb, t, cfg.embed_dim),
                                  stage_dtype(params), tokens.device)
        logits = (torch.cat(banked) if mesh.last else
                  torch.empty((b, t, cfg.vocab_size), dtype=torch.float32,
                              device=tokens.device))
        return broadcast_from(logits, mesh.sampler, mesh.pipe_group)

    return call
