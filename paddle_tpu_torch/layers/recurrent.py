"""Recurrent layers: recurrent, lstmemory and gated_recurrent (the whole
sequence), lstm_step and gru_step (one step of a recurrent group).

Layout contracts (from config_parser LstmLayer/GatedRecurrentLayer):
- lstmemory: the input is the 4*size x-projection, the recurrent weight
  [size, 4*size], the bias 7*size = 4 gate biases + 3 peephole vectors,
  gate order [candidate, input, forget, output];
- gated_recurrent: the input is the 3*size x-projection, the weight
  [size, 3*size] is split [update, reset | candidate], and the bias is
  3*size.

``lstmemory`` and ``gated_recurrent`` decide from the config and the
shapes, before anything runs, as the JAX layers do with their kernels'
``supported()`` gates:
- when the ops module's ``supported(acts, H, B)`` holds (the batch B
  bounds the persistent grids of the backward kernels), the layer calls its
  fused op (:func:`~paddle_tpu_torch.ops.fused_lstm.fused_lstm`,
  :func:`~paddle_tpu_torch.ops.fused_gru.fused_gru`): on the card that
  launches the kernels (the training forward and backward when a gradient
  is wanted, the light forward otherwise), on the CPU it runs the kernels'
  plain version and autograd through it gives the gradients;
- otherwise (an activation outside the kernels' four, an LSTM wider than
  1024, a batch whose rows' state does not fit a block) it runs its own
  eager time loop over the cell, the counterpart of
  the JAX layers' ``lax.scan``, and counts it in the ops module's
  ``EAGER_ROUTES``.
A kernel that fails to build or launch still raises. The
``settings(pallas_rnn=...)`` switch is a TPU choice and chooses nothing here.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, register_layer
from paddle_tpu_torch.ops import fused_gru as fg
from paddle_tpu_torch.ops import fused_lstm as fl
from paddle_tpu_torch.ops.fused_gru import fused_gru, gru_cell
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.ops.fused_lstm import fused_lstm
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor


def _time_major_mask(a: Argument, x: Tensor) -> Tensor:
    pos = torch.arange(x.shape[1], device=x.device)[:, None]
    return (pos < a.seq_lengths[None, :]).to(x.dtype)           # [T, B]


def _weights(cfg: LayerConfig, ctx: LayerContext, gates: int):
    size = cfg.size
    w = ctx.param(cfg.inputs[0].input_parameter_name).reshape(size, gates * size)
    bias = (ctx.param(cfg.bias_parameter_name).reshape(-1)
            if cfg.bias_parameter_name else None)
    return w, bias


@register_layer("lstmemory")
def lstmemory_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    H = cfg.size
    w, bias = _weights(cfg, ctx, 4)
    x = a.value                                                 # [B, T, 4H]
    if bias is not None:
        x = x + bias[:4 * H]
        peep = bias[4 * H:7 * H].reshape(3, H)
    else:
        peep = x.new_zeros(3, H)
    acts = (cfg.active_type or "tanh", cfg.active_gate_type or "sigmoid",
            cfg.active_state_type or "sigmoid")
    x4, mask = x.transpose(0, 1), _time_major_mask(a, x)
    # bf16 operands (a bf16 model) take the kernels' bf16 instances
    if fl.supported(acts, H, x.shape[0]):
        ys = fused_lstm(x4, mask, w, peep, reverse=cfg.reversed, acts=acts)
    else:
        fl.EAGER_ROUTES += 1
        # the eager loop runs in x's dtype, as the JAX layer's lax.scan does
        ys = fl.lstm_loop(x4, mask, w, peep, reverse=cfg.reversed, acts=acts)
    return Argument(value=ys.transpose(0, 1), seq_lengths=a.seq_lengths)


def _gru_acts(cfg: LayerConfig):
    return (cfg.active_type or "tanh", cfg.active_gate_type or "sigmoid")


def gru_cell_step(cfg: LayerConfig, x3: Tensor, h_prev: Tensor, w: Tensor,
                  bias: Optional[Tensor]) -> Tensor:
    """x3 [B, 3*size] x-projection, w [size, 3*size], bias [3*size] or None."""
    if bias is not None:
        x3 = x3 + bias
    return gru_cell(x3, h_prev, w, _gru_acts(cfg))


@register_layer("gated_recurrent")
def gated_recurrent_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    w, bias = _weights(cfg, ctx, 3)
    x = a.value if bias is None else a.value + bias             # [B, T, 3H]
    x3, mask, acts = x.transpose(0, 1), _time_major_mask(a, x), _gru_acts(cfg)
    # bf16 operands (a bf16 model) take the kernels' bf16 instances
    if fg.supported(acts, cfg.size, x.shape[0]):
        ys = fused_gru(x3, mask, w, reverse=cfg.reversed, acts=acts)
    else:
        fg.EAGER_ROUTES += 1
        # the eager loop runs in x's dtype, as the JAX layer's lax.scan does
        ys = fg.gru_loop(x3, mask, w, reverse=cfg.reversed, acts=acts)
    return Argument(value=ys.transpose(0, 1), seq_lengths=a.seq_lengths)


@register_layer("gru_step")
def gru_step_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs: [x-projection 3*size, previous output]
    w, bias = _weights(cfg, ctx, 3)
    h = gru_cell_step(cfg, inputs[0].value, inputs[1].value, w, bias)
    return Argument(value=h, seq_lengths=inputs[0].seq_lengths)


@register_layer("recurrent")
def recurrent_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """The simple RNN, h_t = act(x_t + h_{t-1} w + b), as an eager loop over
    time (the JAX package's ``lax.scan``): a padded step passes the state
    through and outputs zeros."""
    a = inputs[0]
    x = a.value.transpose(0, 1)                                 # [T, B, size]
    mask = _time_major_mask(a, a.value)[..., None]              # [T, B, 1]
    w = ctx.param(cfg.inputs[0].input_parameter_name).reshape(cfg.size, cfg.size)
    if cfg.bias_parameter_name:
        x = x + ctx.param(cfg.bias_parameter_name).reshape(-1)
    T = x.shape[0]
    h = x.new_zeros(x.shape[1], cfg.size)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if cfg.reversed else range(T)):
        h_new = apply_activation(cfg.active_type, x[t] + h @ w)
        ys[t] = h_new * mask[t]
        h = mask[t] * h_new + (1.0 - mask[t]) * h
    return Argument(value=torch.stack(ys).transpose(0, 1), seq_lengths=a.seq_lengths)


@register_layer("lstm_step")
def lstm_step_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """One LSTM step inside a recurrent group: inputs [x-projection 4*size,
    previous cell state]. The output is the hidden state; the new cell
    state is published as "<name>@state" for get_output(arg_name='state').
    A step layer has no recurrent weight: the gates are x (+ bias)."""
    x4, c_prev = inputs[0].value, inputs[1].value
    H = cfg.size
    if cfg.bias_parameter_name:
        bias = ctx.param(cfg.bias_parameter_name).reshape(-1)
        x4 = x4 + bias[:4 * H]
        peep_i, peep_f, peep_o = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    else:
        peep_i = peep_f = peep_o = x4.new_zeros(H)
    gate = cfg.active_gate_type or "sigmoid"
    i = apply_activation(gate, x4[..., H:2 * H] + peep_i * c_prev)
    f = apply_activation(gate, x4[..., 2 * H:3 * H] + peep_f * c_prev)
    c = f * c_prev + i * apply_activation(cfg.active_type or "tanh", x4[..., :H])
    o = apply_activation(gate, x4[..., 3 * H:] + peep_o * c)
    h = o * apply_activation(cfg.active_state_type or "sigmoid", c)
    ctx.outputs[f"{cfg.name}@state"] = Argument(value=c, seq_lengths=inputs[0].seq_lengths)
    return Argument(value=h, seq_lengths=inputs[0].seq_lengths)


@register_layer("mdlstmemory")
def mdlstm_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """The 2-D multi-dimensional LSTM (the reference's MDLstmLayer, Graves'
    MDLSTM) over a nested [B, H, W, (3+D)*size] input of x-projections for
    the blocks [input node, input gate, forget gate x D, output gate]. The
    recurrent weight [size, (3+D)*size] is shared by the D = 2 predecessors
    (top and left); the bias packs the (3+D) gate biases and the peepholes
    checkIg, checkFg x D, checkOg. ``directions[d]`` False runs dimension d
    backwards. Each cell sums its predecessors' outputs through the weight
    and their states through the peepholes, with one forget gate each; a
    predecessor outside the grid contributes zeros.

    The cells of one anti-diagonal i + j = d depend only on diagonal d - 1,
    so the loop runs over the H + W - 1 diagonals, each one batched
    product over its cells. Ragged grids (per-sample sub_seq_lengths) zero
    the outputs and states of the cells outside a sample's grid, which
    makes them absent to their neighbours, as in the JAX layer."""
    a = inputs[0]
    x = a.value
    if x is None or x.dim() != 4:
        raise ValueError("mdlstmemory expects a nested [B, H, W, (3+D)*size] input "
                         "(dense_vector_sub_sequence grid)")
    dirs = list(cfg.directions) or [True, True]
    D = len(dirs)
    if D != 2:
        raise ValueError("mdlstmemory: 2-D grids supported (directions must have 2 entries)")
    nb = cfg.size
    w = ctx.param(cfg.inputs[0].input_parameter_name).reshape(nb, (3 + D) * nb)
    bias = ctx.param(cfg.bias_parameter_name).reshape(-1)
    gate_bias = bias[:(3 + D) * nb]
    check_ig = bias[(3 + D) * nb:(4 + D) * nb]
    check_fg = bias[(4 + D) * nb:(4 + 2 * D) * nb].reshape(D, nb)
    check_og = bias[(4 + 2 * D) * nb:(5 + 2 * D) * nb]

    if a.sub_seq_lengths is not None:
        grid_mask = a.sub_seq_mask(x.dtype)[..., None]            # [B, H, W, 1]
    else:
        grid_mask = x.new_ones(x.shape[:3] + (1,))
    flip = [d + 1 for d in range(D) if not dirs[d]]
    if flip:
        x, grid_mask = torch.flip(x, flip), torch.flip(grid_mask, flip)
    B, H, W, _ = x.shape
    g_all = (x + gate_bias).permute(1, 2, 0, 3)                  # [H, W, B, (3+D)nb]
    m_all = grid_mask.permute(1, 2, 0, 3)                        # [H, W, B, 1]

    act_gate = cfg.active_gate_type or "sigmoid"
    act_in = cfg.active_type or "tanh"
    act_state = cfg.active_state_type or "sigmoid"
    zeros = x.new_zeros(1, B, nb)
    prev_out = prev_st = None        # diagonal d - 1 by row, padded: [H + 1, B, nb]
    ys = x.new_zeros(H, W, B, nb)
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H - 1, d)
        rows = torch.arange(lo, hi + 1, device=x.device)
        g, m = g_all[rows, d - rows], m_all[rows, d - rows]      # [n, B, ...]
        if prev_out is None:
            out_t = out_l = st_t = st_l = zeros
        else:
            # row i's top neighbour is diagonal d - 1's row i - 1, its left
            # neighbour that diagonal's row i
            out_t, out_l = prev_out[lo:hi + 1], prev_out[lo + 1:hi + 2]
            st_t, st_l = prev_st[lo:hi + 1], prev_st[lo + 1:hi + 2]
        g = g + (out_t + out_l) @ w
        ig = apply_activation(act_gate, g[..., nb:2 * nb] + (st_t + st_l) * check_ig)
        fg = apply_activation(act_gate, g[..., 2 * nb:(2 + D) * nb]
                              + torch.cat([st_t * check_fg[0], st_l * check_fg[1]], -1))
        state = (fg[..., :nb] * st_t + fg[..., nb:] * st_l
                 + apply_activation(act_in, g[..., :nb]) * ig)
        og = apply_activation(act_gate, g[..., (2 + D) * nb:] + state * check_og)
        # a cell outside the grid emits zeros, so its neighbours see it absent
        out = og * apply_activation(act_state, state) * m
        state = state * m
        ys[rows, d - rows] = out
        pad = lambda v: torch.cat([zeros.expand(lo + 1, B, nb), v,  # noqa: E731
                                   zeros.expand(H - 1 - hi, B, nb)])
        prev_out, prev_st = pad(out), pad(state)
    out = ys.permute(2, 0, 1, 3)                                  # [B, H, W, nb]
    if flip:
        out = torch.flip(out, flip)
    return Argument(value=out, seq_lengths=a.seq_lengths, sub_seq_lengths=a.sub_seq_lengths)
