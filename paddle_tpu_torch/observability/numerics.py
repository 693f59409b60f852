"""Per-layer model-health telemetry and non-finite blame
(``--numerics_log_period``, ``--nonfinite_policy``).

Port of ``paddle_tpu/observability/numerics.py`` on tensors:

- **in-step health**: :func:`step_health` computes, per layer, the
  squared sums of the gradients, the parameters and the update, and the
  count of non-finite gradient elements, as one ``[layers, 4]`` tensor on
  the device the step ran on. The trainer keeps the newest one and copies
  it to the host only at ``--numerics_log_period`` boundaries and at the
  pass's end, where :func:`derive` turns it into the ``kind=numerics``
  record's per-layer grad norm, param norm, update ratio and count.
- **non-finite blame**: :func:`blame_nonfinite` re-runs a poisoned batch
  layer by layer (the parameters first, then the forward in config
  order, then the gradients) and names the first layer with a non-finite
  value, and the phase it showed in.

:func:`param_owners`, :func:`layer_groups` and :func:`derive` read only
the config and numbers; the analyzers read the records with no device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from paddle_tpu_torch.utils.logging import logger

# epsilon guarding the update-ratio division: an all-zero parameter block
# reads a huge but finite ratio, not an inf
EPS = 1e-12

__all__ = ["param_owners", "layer_groups", "step_health", "derive", "blame_nonfinite"]


# ------------------------------------------------------------- grouping


def param_owners(model) -> Dict[str, str]:
    """{parameter name: owning layer name} from the model config: a layer
    owns the parameters its inputs reference and its bias; first wins on a
    shared parameter, so the earliest layer in config order is the blame
    anchor."""
    owner: Dict[str, str] = {}
    for layer in model.layers:
        for ic in layer.inputs:
            if ic.input_parameter_name:
                owner.setdefault(ic.input_parameter_name, layer.name)
        if layer.bias_parameter_name:
            owner.setdefault(layer.bias_parameter_name, layer.name)
    for sub in getattr(model, "sub_models", []) or []:
        for mem in getattr(sub, "memories", []) or []:
            pn = getattr(mem, "boot_bias_parameter_name", "")
            if pn:
                owner.setdefault(pn, sub.name)
    return owner


def layer_groups(model, param_names) -> Dict[str, List[str]]:
    """{layer name: [its parameter names]} over the given parameters, in
    the order of the sorted names; a parameter no layer claims groups under
    its own name."""
    owner = param_owners(model)
    groups: Dict[str, List[str]] = {}
    for pn in sorted(param_names):
        groups.setdefault(owner.get(pn, pn), []).append(pn)
    return groups


# ------------------------------------------------------- in-step health

# the columns of a layer's health row
GRAD_SS, PARAM_SS, UPDATE_SS, NONFINITE = range(4)


def step_health(params, new_params, grads, groups):
    """``[len(groups), 4]`` float32 on the parameters' device, one row per
    layer in ``groups``' order: Σg², Σp², Σ(p' - p)² and the count of
    non-finite gradient elements. Queues device work only: nothing here
    waits for the card."""
    import torch

    rows = []
    for pnames in groups.values():
        cols = [[], [], [], []]
        for pn in pnames:
            p = params.get(pn)
            if p is None:
                continue
            pf = p.detach().float()
            cols[PARAM_SS].append(torch.sum(pf * pf))
            q = new_params.get(pn)
            if q is not None:
                d = q.detach().float() - pf
                cols[UPDATE_SS].append(torch.sum(d * d))
            g = grads.get(pn)
            if g is not None:
                # a RowSparseGrad's occurrence rows: the only part that exists
                gf = getattr(g, "rows", g).detach().float()
                cols[GRAD_SS].append(torch.sum(gf * gf))
                cols[NONFINITE].append(torch.sum(~torch.isfinite(gf)).float())
        dev = next(iter(params.values())).device
        rows.append(torch.stack([torch.stack(c).sum() if c else torch.zeros((), device=dev)
                                 for c in cols]))
    return torch.stack(rows)


def derive(health, names) -> Tuple[Dict[str, Dict[str, float]], List[str], float]:
    """From one host copy of a health table (rows in ``names``' order;
    a stacked ``[k, layers, 4]`` reports its last row): (per layer
    ``{grad_norm, param_norm, update_ratio, nonfinite}``, the layers with
    non-finite gradients, the global grad norm)."""
    import numpy as np

    h = np.asarray(health, dtype=np.float64)
    if h.ndim == 3:
        h = h[-1]
    layers: Dict[str, Dict[str, float]] = {}
    nf_layers: List[str] = []
    total_gss = 0.0
    rows = dict(zip(names, h))
    for name in sorted(rows):
        gss, pss, uss, nf = (float(x) for x in rows[name][:4])
        # a non-finite gradient poisons its own norm: the count stays honest
        # and the norm is reported as it is
        pn = math.sqrt(pss) if pss >= 0 else float("nan")
        layers[name] = {
            "grad_norm": math.sqrt(gss) if gss >= 0 else float(gss),
            "param_norm": pn,
            "update_ratio": (
                (math.sqrt(uss) if uss >= 0 else float(uss)) / (pn + EPS)
                if math.isfinite(pn) else float("nan")
            ),
            "nonfinite": int(nf) if math.isfinite(nf) else -1,
        }
        if nf > 0 or not math.isfinite(nf):
            nf_layers.append(name)
        if math.isfinite(gss):
            total_gss += gss
    return layers, nf_layers, math.sqrt(total_gss)


# ------------------------------------------------------ non-finite blame


def _nonfinite_count(t) -> int:
    import torch

    if t is None or not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return 0
    return int(t.numel() - int(torch.isfinite(t).sum()))


def blame_nonfinite(gm, model, params, in_args, seed=None) -> Optional[Dict[str, Any]]:
    """Re-run one poisoned batch and name the first layer with a non-finite
    value: {"layer", "phase", "nonfinite", and "param" where one is to
    blame}, or None.

    1. **params**: a non-finite value already in a weight blames its
       owning layer, with no compute;
    2. **forward**: the train forward again (``seed``, the step's, draws
       the same dropout bits), the layer outputs walked in config order;
    3. **backward**: the forward was clean, so the gradients: the
       parameter gradient with non-finite values whose owner comes LAST in
       config order (the first that backpropagation reaches).

    This is the cold path (at most ``--max_nonfinite_steps`` times a run)
    and it copies to the host freely. It never raises: a blame that fails
    returns None and the policy goes on without it."""
    import torch

    try:
        owner = param_owners(model)
        layer_pos = {l.name: i for i, l in enumerate(model.layers)}
        for pn in sorted(sorted(params), key=lambda n: layer_pos.get(owner.get(n, n), 1 << 30)):
            bad = _nonfinite_count(params[pn])
            if bad:
                return {"layer": owner.get(pn, pn), "phase": "params", "param": pn,
                        "nonfinite": bad}
        with torch.no_grad():
            outputs, _ = gm.forward(params, in_args, pass_type="train", seed=seed)
        for layer in model.layers:
            arg = outputs.get(layer.name)
            bad = _nonfinite_count(getattr(arg, "value", None))
            if bad:
                return {"layer": layer.name, "phase": "forward", "nonfinite": bad}
        # dense: a row set does not matter for blame
        _loss, grads, _outs, _updates = gm.grad_fn(sparse=False)(params, in_args, seed)
        worst: Optional[Tuple[int, str, str, int]] = None
        for pn, g in grads.items():
            bad = _nonfinite_count(g)
            if not bad:
                continue
            layer = owner.get(pn, pn)
            pos = layer_pos.get(layer, -1)
            if worst is None or pos > worst[0]:
                worst = (pos, layer, pn, bad)
        if worst is not None:
            return {"layer": worst[1], "phase": "backward", "param": worst[2],
                    "nonfinite": worst[3]}
        return None
    except Exception as e:  # noqa: BLE001 — blame is best effort
        logger.debug("nonfinite blame re-run failed: %s", e, exc_info=True)
        return None
