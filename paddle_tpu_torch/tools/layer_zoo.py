"""The layer zoo: every layer type, projection, mixed-layer operator and
activation of the layer library's tail, and mdlstmemory in its four
directions, at sizes from public models and the repository's demos, run on one device and held against another:
``chip_smoke.py``'s ``layers`` phase runs it on the card against the CPU.

    from paddle_tpu_torch.tools.layer_zoo import build, run, compare
    for e in build(full=True):
        card, step = run(e, "cuda")          # step(): forward + backward again
        cpu, _ = run(e, "cpu")
        compare(e, card, cpu)                # raises where they disagree

Each entry is one layer on seeded numpy inputs (float32; mdlstmemory's in
float64, see build): its output, and
the gradients by autograd of sum(output * R), R a fixed random array of
the output's shape (zero on padded steps), with respect to its parameters
and its float inputs. ``compare`` holds values to 1e-5 of max(1, max
|reference|), gradients to 1e-4 of max(1, max |reference gradient|), and
ids equal, and the steps past each output length exactly 0 on both sides
for the layers that remake a sequence's steps (seqconcat, seqreshape,
subseq, the context projection); where ids may tie (maxid, a max layer's index, a Viterbi path)
an id that differs must be a tie on the reference's own scores (1e-5 of
scale). ``build(full=False)`` gives the same entries at small sizes, which
the CPU tests run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, forward_layer
from paddle_tpu_torch.proto import (BlockExpandConfig, ConvConfig, LayerConfig, LayerInputConfig,
                                    ModelConfig, NormConfig, OperatorConfig, ProjectionConfig)

OUT_TOL, GRAD_TOL, TIE_TOL = 1e-5, 1e-4, 1e-5


@dataclasses.dataclass
class Entry:
    name: str                         # the type, "projection:<t>", "operator:<t>", "act:<a>"
    cfg: LayerConfig
    inputs: List[Dict[str, np.ndarray]]
    params: Dict[str, np.ndarray]
    grad_inputs: Tuple[int, ...]      # inputs whose value gets a gradient
    size: str                         # the shapes, for the report
    source: str                       # where the size comes from
    ties: Optional[str] = None        # "argmax" | "max_index" | "viterbi": how ids may tie
    zero_pad: bool = False            # the steps past each output length must be 0
    dtype: torch.dtype = torch.float32  # of the parameters and float inputs


def _rng(seed):
    return np.random.RandomState(seed)


def _u(shape, seed, lo=-0.5, hi=0.5):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _lengths(B, T, seed, lo=1):
    n = _rng(seed).randint(lo, T + 1, B).astype(np.int32)
    n[0] = T                          # one row fills the padded width
    return n


def _layer(name, ltype, size, inputs, **kw) -> LayerConfig:
    """inputs: [(input layer name, parameter name, extra LayerInputConfig fields)]."""
    cfg = LayerConfig(name=name, type=ltype, size=size, **kw)
    for lname, pname, extra in inputs:
        cfg.inputs.append(LayerInputConfig(input_layer_name=lname, input_parameter_name=pname,
                                           **(extra or {})))
    return cfg


def build(full: bool = True) -> List[Entry]:
    """The zoo's entries: at the public sizes (full) or small ones."""
    if full:
        B, T, D = 128, 100, 512           # the elementwise and sequence types
        V, VD, VB, K = 30000, 512, 256, 5  # hsigmoid, nce, selective_fc
        crf = ((150, 64, 6), (150, 64, 128))
        ctc = (64, 200, 50, 29)
        norm = (64, 96, 55, 5)
        blk = (128, 3, 32, 4)
        lam = (64, 50, 5)
        md = (32, 32, 32, 32)
    else:
        B, T, D = 3, 6, 8
        V, VD, VB, K = 40, 8, 4, 5
        crf = ((3, 5, 3), (3, 5, 4))
        ctc = (3, 9, 3, 5)
        norm = (2, 6, 5, 3)
        blk = (2, 3, 8, 4)
        lam = (3, 6, 5)
        md = (3, 4, 5, 4)
    seq_src = "B 128, T 100, width 512 (seqToseq's and the LSTM classifier's width)"
    L = _lengths(B, T, 1)
    x3 = {"value": _u((B, T, D), 2), "lengths": L}
    rows = B * T
    x2 = {"value": _u((rows, D), 3)}
    out: List[Entry] = []

    def add(name, cfg, inputs, params=None, grad=(0,), size="", source=seq_src, ties=None,
            zero_pad=False, dtype=torch.float32):
        out.append(Entry(name, cfg, inputs, params or {}, tuple(grad), size, source, ties,
                         zero_pad, dtype))

    sz_seq = f"[{B}, {T}, {D}]"
    sz_rows = f"[{rows}, {D}]"
    # ------------------------------------------------------ activations
    for act in ("stanh", "brelu", "softrelu", "abs", "square", "exponential"):
        scale = 30.0 if act == "brelu" else 4.0       # brelu's bound at 24 lies inside
        cfg = _layer(f"act_{act}", "mixed", D, [("x", "", dict(
            proj_conf=ProjectionConfig(type="identity", input_size=D, output_size=D)))],
            active_type=act)
        add(f"act:{act}", cfg, [{"value": scale * _u((B, T, D), 4), "lengths": L}],
            size=sz_seq)
    # ------------------------------------------------------ projections
    cfg = _layer("ctx", "mixed", 3 * D, [("x", "", dict(proj_conf=ProjectionConfig(
        type="context", input_size=D, output_size=3 * D, context_start=-1, context_length=3)))])
    add("projection:context", cfg, [x3], size=sz_seq + ", context_len 3",
        source="quick_start trainer_config.cnn.py (context_len=3) at [128, 100, 512]",
        zero_pad=True)
    cfg = _layer("ctx_pad", "mixed", 5 * D, [("x", "_pad", dict(proj_conf=ProjectionConfig(
        type="context", input_size=D, output_size=5 * D, context_start=-2, context_length=5,
        trainable_padding=True)))])
    add("projection:context_trainable_padding", cfg, [x3], {"_pad": _u((4, D), 5)},
        size=sz_seq + ", context_len 5, start -2", source=seq_src, zero_pad=True)
    cfg = _layer("io", "mixed", D // 2, [("x", "", dict(proj_conf=ProjectionConfig(
        type="identity_offset", input_size=D, output_size=D // 2, offset=D // 4)))])
    add("projection:identity_offset", cfg, [x3], size=sz_seq)
    cfg = _layer("dm", "mixed", D, [("x", "_dm", dict(proj_conf=ProjectionConfig(
        type="dot_mul", input_size=D, output_size=D)))])
    add("projection:dot_mul", cfg, [x3], {"_dm": _u((1, D), 6)}, size=sz_seq)
    cfg = _layer("tfc", "mixed", D, [("x", "_tfc", dict(proj_conf=ProjectionConfig(
        type="trans_fc", input_size=D, output_size=D)))])
    add("projection:trans_fc", cfg, [x3], {"_tfc": _u((D, D), 7, -0.05, 0.05)}, size=sz_seq)
    # ------------------------------------------------------ operators
    cfg = _layer("dmo", "mixed", D, [("x", "", None), ("y", "", None)])
    cfg.operator_confs.append(OperatorConfig(type="dot_mul", input_indices=[0, 1],
                                             output_size=D, dotmul_scale=1.5))
    add("operator:dot_mul", cfg, [x3, {"value": _u((B, T, D), 8), "lengths": L}],
        grad=(0, 1), size=sz_seq)
    cb, cc, img, nf = (128, 3, 32, 16) if full else (2, 2, 6, 3)
    conv = ConvConfig(filter_size=3, channels=cc, stride=1, padding=1, groups=1,
                      filter_channels=cc, output_x=img, img_size=img)
    cfg = _layer("convop", "mixed", nf * img * img, [("img", "", None), ("filt", "", None)])
    cfg.operator_confs.append(OperatorConfig(type="conv", input_indices=[0, 1],
                                             conv_conf=conv, num_filters=nf,
                                             output_size=nf * img * img))
    add("operator:conv", cfg, [{"value": _u((cb, cc * img * img), 9)},
                               {"value": _u((cb, nf * cc * 9), 10)}], grad=(0, 1),
        size=f"[{cb}, {cc}x{img}x{img}], {nf} filters 3x3 a sample",
        source="CIFAR 3x32x32 (vgg_16_cifar.py), 16 per-sample 3x3 filters, B 128")
    # ------------------------------------------------------ core layers
    cfg = _layer("c2", "concat2", 2 * D, [
        ("x", "_c2w", dict(proj_conf=ProjectionConfig(type="fc", input_size=D, output_size=D))),
        ("y", "", dict(proj_conf=ProjectionConfig(type="identity", input_size=D,
                                                  output_size=D)))])
    add("concat2", cfg, [x3, {"value": _u((B, T, D), 11), "lengths": L}],
        {"_c2w": _u((D, D), 12, -0.05, 0.05)}, grad=(0, 1), size=sz_seq)
    tn, tk = (256, 16) if full else (4, 3)
    cfg = _layer("tensor", "tensor", tk, [("x", "_tw", None), ("y", "", None)])
    add("tensor", cfg, [{"value": _u((rows, tn), 13)}, {"value": _u((rows, tn), 14)}],
        {"_tw": _u((tn, tk * tn), 15, -0.05, 0.05)}, grad=(0, 1),
        size=f"[{rows}, {tn}] x [{rows}, {tn}] -> {tk}")
    cfg = _layer("prelu", "prelu", D, [("x", "_pw", None)], partial_sum=4)
    add("prelu", cfg, [x3], {"_pw": _u((1, D // 4), 16, 0.0, 0.5)}, size=sz_seq)
    cfg = _layer("maxid", "maxid", 1, [("x", "", None)])
    add("maxid", cfg, [x3], size=sz_seq, ties="argmax")
    cfg = _layer("eos", "eos_id", 1, [("x", "", None)], eos_id=3)
    add("eos_id", cfg, [{"ids": _rng(17).randint(0, 8, (B, T)).astype(np.int32),
                         "lengths": L}], grad=(), size=f"[{B}, {T}] ids")
    cfg = _layer("trans", "trans", rows, [("x", "", None)])
    add("trans", cfg, [x2], size=sz_rows)
    cfg = _layer("getout", "get_output", D, [("x", "", None)])
    add("get_output", cfg, [x3], size=sz_seq)
    # ------------------------------------------------------ sequence
    cfg = _layer("maxidx", "max", D, [("x", "", None)], output_max_index=True)
    add("max(output_max_index)", cfg, [x3], grad=(), size=sz_seq, ties="max_index")
    cfg = _layer("first", "seqfirstins", D, [("x", "", None)])
    add("seqfirstins", cfg, [x3], size=sz_seq)
    cfg = _layer("sc", "seqconcat", D, [("x", "", None), ("y", "", None)])
    add("seqconcat", cfg, [x3, {"value": _u((B, T, D), 18), "lengths": _lengths(B, T, 19)}],
        grad=(0, 1), size=f"{sz_seq} + {sz_seq}", zero_pad=True)
    cfg = _layer("sr", "seqreshape", D // 2, [("x", "", None)])
    add("seqreshape", cfg, [x3], size=sz_seq + f" -> width {D // 2}", zero_pad=True)
    offs = _rng(20).randint(0, T // 2, B).astype(np.int32)
    sizes = np.minimum(_rng(21).randint(1, T // 2 + 1, B), L - offs).clip(min=1).astype(np.int32)
    cfg = _layer("subseq", "subseq", D, [("x", "", None), ("o", "", None), ("s", "", None)])
    add("subseq", cfg, [x3, {"ids": offs}, {"ids": sizes}], size=sz_seq, zero_pad=True)
    # ------------------------------------------------------ costs
    probs = _rng(22).dirichlet(np.ones(D), (B, T)).astype(np.float32)
    labels = {"ids": _rng(23).randint(0, D, (B, T)).astype(np.int32), "lengths": L}
    cfg = _layer("selfnorm", "multi_class_cross_entropy_with_selfnorm", 1,
                 [("p", "", None), ("l", "", None)], coeff=1.0, softmax_selfnorm_alpha=0.1)
    add("multi_class_cross_entropy_with_selfnorm", cfg,
        [{"value": 1.3 * probs, "lengths": L}, labels], size=sz_seq)
    cfg = _layer("se", "square_error", 1, [("p", "", None), ("y", "", None)], coeff=1.0)
    add("square_error", cfg, [x3, {"value": _u((B, T, D), 24), "lengths": L}], size=sz_seq)
    p01 = {"value": _u((B, T, D), 25, 0.02, 0.98), "lengths": L}
    y01 = {"value": (_u((B, T, D), 26, 0, 1) > 0.5).astype(np.float32), "lengths": L}
    cfg = _layer("mbce", "multi_binary_label_cross_entropy", 1,
                 [("p", "", None), ("y", "", None)], coeff=1.0)
    add("multi_binary_label_cross_entropy", cfg, [p01, y01], size=sz_seq)
    cfg = _layer("sbce", "soft_binary_class_cross_entropy", 1,
                 [("p", "", None), ("y", "", None)], coeff=1.0)
    add("soft_binary_class_cross_entropy", cfg,
        [p01, {"value": _u((B, T, D), 27, 0, 1), "lengths": L}], size=sz_seq)
    s1, s2 = {"value": _u((rows, 1), 28, -3, 3)}, {"value": _u((rows, 1), 29, -3, 3)}
    cfg = _layer("rank", "rank-cost", 1, [("a", "", None), ("b", "", None), ("l", "", None)],
                 coeff=1.0)
    add("rank-cost", cfg, [s1, s2, {"value": _rng(30).choice(
        [0.0, 0.5, 1.0], (rows, 1)).astype(np.float32)}], grad=(0, 1), size=f"[{rows}, 1]")
    cfg = _layer("huber", "huber", 1, [("s", "", None), ("l", "", None)], coeff=1.0)
    add("huber", cfg, [s1, {"ids": _rng(31).randint(0, 2, rows).astype(np.int32)}],
        size=f"[{rows}, 1]")
    for vt in ("auc-validation", "pnpair-validation"):
        cfg = _layer(vt, vt, 1, [("p", "", None), ("l", "", None)], coeff=1.0)
        add(vt, cfg, [{"value": _u((rows, 2), 32, 0, 1)},
                      {"ids": _rng(33).randint(0, 2, rows).astype(np.int32)}], grad=(),
            size=f"[{rows}, 2]")
    cfg = _layer("cerr", "classification_error", 1, [("p", "", None), ("l", "", None)],
                 coeff=1.0)
    add("classification_error", cfg, [x3, labels], grad=(), size=sz_seq, ties="argmax")
    # ------------------------------------------------------ misc
    w1 = {"value": _u((rows, 1), 34, 0, 1)}
    cfg = _layer("interp", "interpolation", D, [("w", "", None), ("x", "", None),
                                                  ("y", "", None)])
    add("interpolation", cfg, [w1, x2, {"value": _u((rows, D), 35)}], grad=(0, 1, 2),
        size=sz_rows)
    cfg = _layer("pow", "power", D, [("w", "", None), ("x", "", None)])
    add("power", cfg, [{"value": _u((rows, 1), 36, 0.5, 2.0)}, {"value": _u((rows, D), 37, 0.1,
                                                                            2.0)}],
        grad=(0, 1), size=sz_rows)
    cfg = _layer("si", "slope_intercept", D, [("x", "", None)], slope=2.0, intercept=0.5)
    add("slope_intercept", cfg, [x3], size=sz_seq)
    cfg = _layer("s1n", "sum_to_one_norm", D, [("x", "", None)])
    add("sum_to_one_norm", cfg, [{"value": _u((B, T, D), 38, 0.1, 1.0), "lengths": L}],
        size=sz_seq)
    M = 4
    cfg = _layer("cc", "convex_comb", D, [("w", "", None), ("v", "", None)])
    add("convex_comb", cfg, [{"value": _u((rows, M), 39, 0, 1)},
                             {"value": _u((rows, M * D), 40)}], grad=(0, 1),
        size=f"[{rows}, {M}] x [{rows}, {M}*{D}]")
    cfg = _layer("cos", "cos", 1, [("x", "", None), ("y", "", None)], cos_scale=5.0)
    add("cos", cfg, [x3, {"value": _u((B, T, D), 41), "lengths": L}], grad=(0, 1), size=sz_seq)
    cfg = _layer("cosvm", "cos_vm", M, [("x", "", None), ("m", "", None)], cos_scale=5.0)
    add("cos_vm", cfg, [x2, {"value": _u((rows, M * D), 42)}], grad=(0, 1),
        size=f"[{rows}, {D}] x [{rows}, {M}*{D}]")
    on = 64 if full else 4
    cfg = _layer("op", "out_prod", on * on, [("x", "", None), ("y", "", None)])
    add("out_prod", cfg, [{"value": _u((rows, on), 43)}, {"value": _u((rows, on), 44)}],
        grad=(0, 1), size=f"[{rows}, {on}] x [{rows}, {on}]")
    cfg = _layer("cs", "conv_shift", D, [("a", "", None), ("b", "", None)])
    add("conv_shift", cfg, [x2, {"value": _u((rows, 5), 45)}], grad=(0, 1),
        size=f"[{rows}, {D}] (*) [{rows}, 5]")
    cfg = _layer("mux", "multiplex", D, [("i", "", None), ("a", "", None), ("b", "", None),
                                         ("c", "", None)])
    add("multiplex", cfg, [{"ids": _rng(46).randint(0, 3, rows).astype(np.int32)}, x2,
                           {"value": _u((rows, D), 47)}, {"value": _u((rows, D), 48)}],
        grad=(1, 2, 3), size=f"3 x {sz_rows}")
    stats = np.stack([-np.ones(D), np.ones(D), _u((D,), 49) * 100, 40 + _u((D,), 50) * 10,
                      100 * np.ones(D)]).astype(np.float32).reshape(1, 5 * D)
    for strat in ("z-score", "min-max", "decimal-scaling"):
        cfg = _layer(f"dn_{strat}", "data_norm", D, [("x", "_stats", None)],
                     data_norm_strategy=strat)
        add(f"data_norm({strat})", cfg, [x3], {"_stats": stats}, size=sz_seq)
    # hsigmoid and nce at seqToseq's vocabulary
    feats = {"value": _u((VB, VD), 51)}
    cls = {"ids": _rng(52).randint(0, V, VB).astype(np.int32)}
    vsrc = "num_classes 30000 (flagship.nmt_config), dim 512, B 256"
    cfg = _layer("hs", "hsigmoid", 1, [("f", "_hsw", None), ("c", "", None)], num_classes=V,
                 bias_parameter_name="_hsb")
    add("hsigmoid", cfg, [feats, cls], {"_hsw": _u((V - 1, VD), 53, -0.05, 0.05),
                                         "_hsb": _u((1, V - 1), 54, -0.05, 0.05)},
        size=f"[{VB}, {VD}], {V} classes", source=vsrc)
    cfg = _layer("nce", "nce", 1, [("f", "_ncew", None), ("c", "", None)], num_classes=V,
                 num_neg_samples=K, bias_parameter_name="_nceb")
    add("nce", cfg, [feats, cls], {"_ncew": _u((V, VD), 55, -0.05, 0.05),
                                    "_nceb": _u((1, V), 56, -0.05, 0.05)},
        size=f"[{VB}, {VD}], {V} classes, {K} negatives",
        source=vsrc + ", k 5 (word2vec's default negatives)")
    # ------------------------------------------------------ recurrent
    cfg = _layer("rnn", "recurrent", D, [("x", "_rw", None)], active_type="tanh",
                 bias_parameter_name="_rb")
    add("recurrent", cfg, [x3], {"_rw": _u((D, D), 57, -0.05, 0.05), "_rb": _u((1, D), 58)},
        size=sz_seq)
    cfg = _layer("lstep", "lstm_step", D, [("x", "", None), ("c", "", None)],
                 active_type="tanh", active_gate_type="sigmoid", active_state_type="tanh",
                 bias_parameter_name="_lb")
    add("lstm_step", cfg, [{"value": _u((B, 4 * D), 59)}, {"value": _u((B, D), 60)}],
        {"_lb": _u((1, 7 * D), 61)}, grad=(0, 1), size=f"[{B}, 4*{D}], state [{B}, {D}]")
    # ------------------------------------------------------ structured
    for cb_, ct, C in crf:
        Lc = _lengths(cb_, ct, 62)
        emis = {"value": _u((cb_, ct, C), 63, -2, 2), "lengths": Lc}
        tags = {"ids": _rng(64).randint(0, C, (cb_, ct)).astype(np.int32), "lengths": Lc}
        w = {"_crfw": _u((C + 2, C), 65, -1, 1)}
        src = (f"B 150 (db_lstm.py), ragged T <= 64, C {C} "
               + ("(semantic_role_labeling/common.py:12)" if C == 6 else ""))
        add(f"crf(C={C})", _layer(f"crf{C}", "crf", C, [("x", "_crfw", None), ("l", "", None)],
                                   coeff=1.0), [emis, tags], w,
            size=f"[{cb_}, {ct}, {C}]", source=src)
        add(f"crf_decoding(C={C})", _layer(f"dec{C}", "crf_decoding", C,
                                           [("x", "_crfw", None)]),
            [emis], w, grad=(), size=f"[{cb_}, {ct}, {C}]", source=src, ties="viterbi")
    cb_, ct, cl, C = ctc
    Lt = _lengths(cb_, ct, 66, lo=ct // 2)
    logits = _u((cb_, ct, C), 67, -2, 2)
    sm = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    Ll = np.minimum(_rng(68).randint(1, cl + 1, cb_), Lt // 2).astype(np.int32)
    add("ctc", _layer("ctc", "ctc", C, [("p", "", None), ("l", "", None)], coeff=1.0,
                      norm_by_times=True),
        [{"value": sm.astype(np.float32), "lengths": Lt},
         {"ids": _rng(69).randint(0, C - 1, (cb_, cl)).astype(np.int32), "lengths": Ll}],
        size=f"[{cb_}, {ct}, {C}], labels <= {cl}",
        source="B 64, T <= 200 frames, labels <= 50, C 29 with the blank (DeepSpeech 2)")
    lb, lt, k = lam
    Lq = _lengths(lb, lt, 70, lo=2)
    add("lambda_cost", _layer("lambda", "lambda_cost", 1, [("s", "", None), ("r", "", None)],
                              coeff=1.0, NDCG_num=k),
        [{"value": _u((lb, lt, 1), 71, -2, 2), "lengths": Lq},
         {"value": _rng(72).randint(0, 4, (lb, lt, 1)).astype(np.float32), "lengths": Lq}],
        size=f"[{lb}, {lt}] lists, NDCG@{k}", source="B 64 queries of <= 50 documents, NDCG@5")
    nsel = 64 if full else 3
    sel = {"ids": np.stack([_rng(73 + i).choice(V, nsel, replace=False)
                            for i in range(VB)]).astype(np.int32)}
    cfg = _layer("sfc", "selective_fc", V, [("x", "_sfw", None), ("sel", "", None)],
                 active_type="sigmoid", bias_parameter_name="_sfb")
    add("selective_fc", cfg, [feats, sel], {"_sfw": _u((VD, V), 74, -0.05, 0.05),
                                            "_sfb": _u((1, V), 75, -0.05, 0.05)},
        size=f"[{VB}, {VD}] -> {V}, {nsel} selected a row",
        source="512 -> 30000, 64 selected columns a row, B 256")
    # ------------------------------------------------------ vision
    nb, nc_, ni, ns = norm
    ncfg = NormConfig(norm_type="cmrnorm-projection", channels=nc_, size=ns, scale=1e-4 / ns,
                      pow=0.75, output_x=ni, img_size=ni)
    for nt in ("norm", "norm-projection"):
        add(nt, _layer(nt, nt, nc_ * ni * ni, [("x", "", dict(norm_conf=ncfg))]),
            [{"value": _u((nb, nc_ * ni * ni), 76, -10, 10)}],
            size=f"[{nb}, {nc_}x{ni}x{ni}], size {ns}",
            source="AlexNet conv1 output 96x55x55, size 5, B 64")
    bb, bc, bi, bs = blk
    bcfg = BlockExpandConfig(channels=bc, stride_x=bs, stride_y=bs, block_x=bs, block_y=bs,
                             output_x=bi // bs, output_y=bi // bs, img_size_x=bi, img_size_y=bi)
    add("blockexpand", _layer("be", "blockexpand", bc * bs * bs,
                              [("x", "", dict(block_expand_conf=bcfg))]),
        [{"value": _u((bb, bc * bi * bi), 77)}], size=f"[{bb}, {bc}x{bi}x{bi}], {bs}x{bs} blocks",
        source="CIFAR 3x32x32 in 4x4 blocks, stride 4, B 128 (vgg_16_cifar.py:31)")
    add("featmap_expand", _layer("fe", "featmap_expand", 4 * D, [("x", "", None)],
                                 num_filters=4), [x3], size=sz_seq + " x 4")
    add("resize", _layer("rs", "resize", 2 * D, [("x", "", None)]), [x2],
        size=f"{sz_rows} -> width {2 * D}")
    # ------------------------------------------------------ nested
    # mdlstmemory over a ragged grid: each sample's rows (seq_lengths) and
    # its row width (sub_seq_lengths), one sample filling the whole grid. In
    # float64 on both devices: over the 63 anti-diagonals of a 32 x 32 grid
    # the float32 result lies 1e-5-4e-5 of scale from its own float64 value
    # on the CPU (at these parameters and at the layer's default init alike),
    # so no two float32 summation orders meet the zoo's 1e-5; chip_smoke.py
    # prints both float32 readings of these entries beside the float64 check
    mb, mh, mw, mn = md
    rows_of, width_of = _lengths(mb, mh, 95), _lengths(mb, mw, 96)
    grid = {"value": _u((mb, mh, mw, 5 * mn), 97), "lengths": rows_of,
            "sub_lengths": np.where(np.arange(mh)[None, :] < rows_of[:, None],
                                    width_of[:, None], 0).astype(np.int32)}
    for dirs in ((True, True), (True, False), (False, True), (False, False)):
        tag = "".join("f" if d else "b" for d in dirs)
        cfg = _layer(f"md_{tag}", "mdlstmemory", mn, [("x", "_mdw", None)],
                     bias_parameter_name="_mdb", directions=list(dirs))
        add(f"mdlstmemory:{tag}", cfg, [grid], {"_mdw": _u((mn, 5 * mn), 98),
                                               "_mdb": _u((1, 9 * mn), 99)},
            size=f"[{mb}, {mh}, {mw}, {5 * mn}], size {mn}, ragged, float64",
            source="a CIFAR image's 32 x 32 grid, size 32, B 32", dtype=torch.float64)
    return out


def _args(e: Entry, device) -> List[Argument]:
    args = []
    for i, spec in enumerate(e.inputs):
        get = lambda k, dt: (None if spec.get(k) is None  # noqa: E731
                             else torch.as_tensor(spec[k], dtype=dt, device=device))
        a = Argument(value=get("value", e.dtype), ids=get("ids", torch.int32),
                     seq_lengths=get("lengths", torch.int32),
                     sub_seq_lengths=get("sub_lengths", torch.int32))
        if i in e.grad_inputs:
            a.value.requires_grad_(True)
        args.append(a)
    return args


def _nce_negatives(e: Entry) -> np.ndarray:
    """The negatives both devices use, drawn once on the host (the card's
    own draws cannot repeat the CPU's) and put on the device before the
    first forward, so a timed step holds no host draw or copy."""
    B = e.inputs[0]["value"].shape[0]
    return _rng(90).randint(0, e.cfg.num_classes, (B, e.cfg.num_neg_samples))


def run(e: Entry, device) -> Tuple[dict, Callable[[], None]]:
    """The entry on ``device``: {"value", "ids", "lengths", "grads"} as
    numpy, and a closure that runs forward and backward again (for timing)."""
    device = torch.device(device)
    params = {k: torch.tensor(v, dtype=e.dtype, device=device, requires_grad=True)
              for k, v in e.params.items()}
    args = _args(e, device)
    R = None
    if e.cfg.type == "nce":
        from paddle_tpu_torch.layers import misc

        neg = torch.as_tensor(_nce_negatives(e), device=device)

    def forward():
        ctx = LayerContext(params=params, model=ModelConfig(), pass_type="train", seed=1)
        if e.cfg.type == "nce":
            cost = misc.nce_cost(e.cfg, args[:1], args[1].ids.long(), neg, ctx)
            return Argument(value=cost[:, None])
        return forward_layer(e.cfg, args, ctx)

    leaves = list(params.values()) + [args[i].value for i in e.grad_inputs]

    def step(out=None):
        nonlocal R
        out = out if out is not None else forward()
        if out.value is None or not leaves:
            return out, []
        v = out.value
        if R is None:
            r = _u(tuple(v.shape), 91)
            if out.seq_lengths is not None and v.dim() == 3:
                lens = out.seq_lengths.cpu().numpy()
                r = r * (np.arange(v.shape[1])[None, :] < lens[:, None])[..., None]
            R = torch.as_tensor(r, dtype=v.dtype, device=device)
        return out, list(torch.autograd.grad(torch.sum(v * R), leaves, allow_unused=True))

    out, grads = step()
    for t in (out.value, out.ids):
        assert t is None or t.device.type == device.type, (e.name, t.device, device)
    res = {"value": None if out.value is None else out.value.detach().cpu().numpy(),
           "ids": None if out.ids is None else out.ids.cpu().numpy(),
           "lengths": None if out.seq_lengths is None else out.seq_lengths.cpu().numpy(),
           "grads": [None if g is None else g.cpu().numpy() for g in grads]}
    return res, lambda: step()


def _scale_err(got, want):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    return float(np.abs(got.astype(np.float64) - want).max()) / scale if want.size else 0.0


def _valid(x, lengths, pad=False):
    """x with the steps at or past each length zeroed; with ``pad``, the
    steps before it zeroed instead."""
    if lengths is None or x.ndim < 2 or x.shape[0] != len(lengths):
        return np.zeros_like(x) if pad else x
    keep = np.arange(x.shape[1])[None, :] < lengths[:, None]
    keep = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    return np.where(keep, 0, x) if pad else np.where(keep, x, 0)


def _viterbi_score(x, param, path, n):
    a, b, w = param[0], param[1], param[2:]
    s = a[path[0]] + b[path[n - 1]] + x[np.arange(n), path[:n]].sum()
    return float(s + w[path[:n - 1], path[1:n]].sum())


def compare(e: Entry, got: dict, ref: dict) -> dict:
    """Hold ``got`` to ``ref``; raises AssertionError where they disagree.
    Returns the errors: value and gradient (each relative to the scale),
    ids that differ, and of those the ties."""
    rep = {"value_err": 0.0, "grad_err": 0.0, "ids_differ": 0, "ids_tied": 0}
    if ref["lengths"] is not None:
        assert np.array_equal(got["lengths"], ref["lengths"]), e.name
    if e.zero_pad:
        for side, res in (("got", got), ("ref", ref)):
            assert res["lengths"] is not None and not np.any(
                _valid(res["value"], res["lengths"], pad=True)), (e.name, "pad rows not 0", side)
    rep.update(errors(got, ref))
    assert rep["value_err"] <= OUT_TOL, (e.name, "value", rep["value_err"])
    if ref["ids"] is not None:
        g, r = _valid(got["ids"], ref["lengths"]), _valid(ref["ids"], ref["lengths"])
        differ = np.argwhere(g != r)
        rep["ids_differ"] = len(differ)
        if len(differ):
            assert e.ties, (e.name, "ids differ", len(differ))
            rep["ids_tied"] = _count_ties(e, g, r, differ)
            assert rep["ids_tied"] == len(differ), (e.name, "ids differ off a tie", rep)
    for i, (g, r) in enumerate(zip(got["grads"], ref["grads"])):
        if r is None:
            assert g is None or not np.any(g), (e.name, i)
    assert rep["grad_err"] <= GRAD_TOL, (e.name, "grad", rep["grad_err"])
    return rep


def errors(got: dict, ref: dict) -> dict:
    """The value error and the largest gradient error of ``got`` against
    ``ref``, each relative to the reference's scale, with nothing asserted."""
    value_err = 0.0 if ref["value"] is None else _scale_err(
        _valid(got["value"], ref["lengths"]), _valid(ref["value"], ref["lengths"]))
    grad_err = max([_scale_err(g, r) for g, r in zip(got["grads"], ref["grads"])
                    if r is not None], default=0.0)
    return {"value_err": value_err, "grad_err": grad_err}


def _count_ties(e: Entry, got_ids, ref_ids, differ) -> int:
    """The differing ids that tie on the reference's own inputs."""
    if e.ties == "argmax":
        x = e.inputs[0]["value"]
        return sum(abs(float(x[tuple(ix)][got_ids[tuple(ix)]] - x[tuple(ix)][ref_ids[tuple(ix)]]))
                   <= TIE_TOL * max(1.0, float(np.abs(x[tuple(ix)]).max())) for ix in differ)
    if e.ties == "max_index":
        x = e.inputs[0]["value"]
        return sum(abs(float(x[b, got_ids[b, d], d] - x[b, ref_ids[b, d], d])) <= TIE_TOL
                   for b, d in differ)
    x, param = e.inputs[0]["value"], e.params["_crfw"]
    lengths = e.inputs[0]["lengths"]
    rows = sorted({int(b) for b, _ in differ})
    tied = 0
    for b in rows:
        n = int(lengths[b])
        sg, sr = (_viterbi_score(x[b], param, p, n) for p in (got_ids[b], ref_ids[b]))
        if abs(sg - sr) <= TIE_TOL * max(1.0, abs(sr)):
            tied += int((got_ids[b] != ref_ids[b]).sum())
    return tied

