"""Evaluator DSL (reference: trainer_config_helpers/evaluators.py).

Each call appends an EvaluatorConfig to the model; the runtime implements
them in paddle_tpu_torch.trainer.evaluators.
"""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch.config.builder import current_context
from paddle_tpu_torch.proto import EvaluatorConfig

__all__ = [
    "evaluator_base",
    "classification_error_evaluator",
    "auc_evaluator",
    "rank_auc_evaluator",
    "seq_classification_error_evaluator",
    "pnpair_evaluator",
    "precision_recall_evaluator",
    "ctc_error_evaluator",
    "chunk_evaluator",
    "sum_evaluator",
    "column_sum_evaluator",
    "value_printer_evaluator",
    "gradient_printer_evaluator",
    "maxid_printer_evaluator",
    "maxframe_printer_evaluator",
    "seqtext_printer_evaluator",
    "classification_error_printer_evaluator",
]


def evaluator_base(
    type: str,
    input,
    label=None,
    weight=None,
    name: Optional[str] = None,
    chunk_scheme: Optional[str] = None,
    num_chunk_types: Optional[int] = None,
    classification_threshold: Optional[float] = None,
    positive_label: Optional[int] = None,
    dict_file: Optional[str] = None,
    result_file: Optional[str] = None,
    num_results: Optional[int] = None,
    delimited: Optional[bool] = None,
):
    ctx = current_context()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    cfg = EvaluatorConfig(name=name or ctx.unique_name(f"eval_{type}"), type=type)
    for i in inputs:
        cfg.input_layers.append(i.name)
    if label is not None:
        cfg.input_layers.append(label.name)
    if weight is not None:
        cfg.input_layers.append(weight.name)
    if chunk_scheme is not None:
        cfg.chunk_scheme = chunk_scheme
        cfg.num_chunk_types = num_chunk_types or 0
    if classification_threshold is not None:
        cfg.classification_threshold = classification_threshold
    if positive_label is not None:
        cfg.positive_label = positive_label
    if dict_file is not None:
        cfg.dict_file = dict_file
    if result_file is not None:
        cfg.result_file = result_file
    if num_results is not None:
        cfg.num_results = num_results
    if delimited is not None:
        cfg.delimited = delimited
    ctx.model.evaluators.append(cfg)
    if ctx.submodel_stack:
        ctx.submodel_stack[-1].evaluator_names.append(cfg.name)
    return cfg


def classification_error_evaluator(input, label, name=None, weight=None, threshold=None):
    return evaluator_base(
        "classification_error", input, label, weight, name, classification_threshold=threshold
    )


def auc_evaluator(input, label, name=None, weight=None):
    return evaluator_base("last-column-auc", input, label, weight, name)


def rank_auc_evaluator(input, click, pv=None, name=None):
    """AUC over rank-model scores (ref: RankAucEvaluator, Evaluator.h:202)."""
    return evaluator_base("rank-auc", input, click, pv, name)


def seq_classification_error_evaluator(input, label, name=None):
    """Per-sequence classification error (ref: Evaluator.cpp:111)."""
    return evaluator_base("seq_classification_error", input, label, None, name)


def pnpair_evaluator(input, info, name=None, weight=None):
    return evaluator_base("pnpair", input, info, weight, name)


def precision_recall_evaluator(input, label, positive_label=None, weight=None, name=None):
    return evaluator_base(
        "precision_recall", input, label, weight, name, positive_label=positive_label
    )


def ctc_error_evaluator(input, label, name=None):
    return evaluator_base("ctc_edit_distance", input, label, None, name)


def chunk_evaluator(input, label, chunk_scheme, num_chunk_types, name=None):
    return evaluator_base(
        "chunk", input, label, None, name, chunk_scheme=chunk_scheme, num_chunk_types=num_chunk_types
    )


def sum_evaluator(input, name=None, weight=None):
    return evaluator_base("sum", input, None, weight, name)


def column_sum_evaluator(input, name=None, weight=None):
    return evaluator_base("last-column-sum", input, None, weight, name)


def value_printer_evaluator(input, name=None):
    return evaluator_base("value_printer", input, None, None, name)


def gradient_printer_evaluator(input, name=None):
    return evaluator_base("gradient_printer", input, None, None, name)


def maxid_printer_evaluator(input, num_results=None, name=None):
    return evaluator_base("max_id_printer", input, None, None, name, num_results=num_results)


def maxframe_printer_evaluator(input, num_results=None, name=None):
    return evaluator_base("max_frame_printer", input, None, None, name, num_results=num_results)


def seqtext_printer_evaluator(input, result_file, id_input=None, dict_file=None, delimited=None, name=None):
    inputs = [input] if id_input is None else [id_input, input]
    return evaluator_base(
        "seq_text_printer", inputs, None, None, name,
        dict_file=dict_file, result_file=result_file, delimited=delimited,
    )


def classification_error_printer_evaluator(input, label, threshold=0.5, name=None):
    return evaluator_base(
        "classification_error_printer", input, label, None, name,
        classification_threshold=threshold,
    )
