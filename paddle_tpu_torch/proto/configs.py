"""Config messages — the model/trainer schema.

Field names and defaults mirror the reference protobuf contract
(/root/reference/proto/ModelConfig.proto.m4, TrainerConfig.proto.m4,
ParameterConfig.proto.m4, DataConfig.proto.m4) so configs written against
the reference DSL parse to the same logical structure. Fields that only
made sense for the 2016 CPU/GPU runtime (device pinning, selective-fc
thread counts, owlqn line-search knobs) are kept where demos/config_parser
touch them and ignored by the TPU runtime, which documents its divergences
in doc/divergences.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from paddle_tpu_torch.proto.message import Message

MAX_I64 = 0x7FFFFFFFFFFFFFFF


# ---------------------------------------------------------------- parameters


@dataclass
class ParameterUpdaterHookConfig(Message):
    # ref: ParameterConfig.proto.m4 ParameterUpdaterHookConfig (static pruning mask)
    type: str = ""
    purning_mask_filename: str = ""  # sic — reference field name preserved


@dataclass
class ParameterConfig(Message):
    # ref: ParameterConfig.proto.m4:21-51
    name: str = ""
    size: int = 0
    learning_rate: float = 1.0
    momentum: float = 0.0
    initial_mean: float = 0.0
    initial_std: float = 0.01
    decay_rate: float = 0.0
    decay_rate_l1: float = 0.0
    dims: List[int] = field(default_factory=list)
    device: int = -1
    initial_strategy: int = 0  # 0 = normal(mean,std), 1 = uniform
    initial_smart: bool = False
    num_batches_regularization: int = 1
    is_sparse: bool = False
    format: str = "csr"
    sparse_remote_update: bool = False
    gradient_clipping_threshold: float = 0.0
    is_static: bool = False
    para_id: int = 0
    update_hooks: List[ParameterUpdaterHookConfig] = field(default_factory=list)
    need_compact: bool = False
    sparse_update: bool = False
    is_shared: bool = False
    parameter_block_size: int = 0
    # TPU extension: logical sharding spec, e.g. ("model", None) to shard dim 0
    # over the "model" mesh axis. Empty = replicated.
    sharding: List[Optional[str]] = field(default_factory=list)


# ------------------------------------------------------------------- layers


@dataclass
class ActivationConfig(Message):
    type: str = ""


@dataclass
class ConvConfig(Message):
    # ref: ModelConfig.proto.m4 ConvConfig
    filter_size: int = 0
    channels: int = 0
    stride: int = 1
    padding: int = 0
    groups: int = 1
    filter_channels: int = 0
    output_x: int = 0
    img_size: int = 0
    caffe_mode: bool = True
    filter_size_y: int = 0
    padding_y: int = -1   # -1 = unset → fall back to padding
    stride_y: int = 0     # 0 = unset → fall back to stride


@dataclass
class PoolConfig(Message):
    pool_type: str = ""
    channels: int = 0
    size_x: int = 0
    start: int = 0
    stride: int = 1
    output_x: int = 0
    img_size: int = 0
    padding: int = 0
    size_y: int = 0
    stride_y: int = 0
    output_y: int = 0
    img_size_y: int = 0
    padding_y: int = 0


@dataclass
class NormConfig(Message):
    norm_type: str = ""
    channels: int = 0
    size: int = 0
    scale: float = 0.0
    pow: float = 0.0
    output_x: int = 0
    img_size: int = 0
    blocked: bool = False


@dataclass
class BlockExpandConfig(Message):
    channels: int = 0
    stride_x: int = 0
    stride_y: int = 0
    padding_x: int = 0
    padding_y: int = 0
    block_x: int = 0
    block_y: int = 0
    output_x: int = 0
    output_y: int = 0
    img_size_x: int = 0
    img_size_y: int = 0


@dataclass
class ImageConfig(Message):
    channels: int = 0
    img_size: int = 0


@dataclass
class ProjectionConfig(Message):
    type: str = ""
    name: str = ""
    input_size: int = 0
    output_size: int = 0
    context_start: int = 0
    context_length: int = 0
    trainable_padding: bool = False
    conv_conf: Optional[ConvConfig] = None
    num_filters: int = 0
    offset: int = 0


@dataclass
class OperatorConfig(Message):
    type: str = ""
    input_indices: List[int] = field(default_factory=list)
    input_sizes: List[int] = field(default_factory=list)
    output_size: int = 0
    dotmul_scale: float = 1.0
    conv_conf: Optional[ConvConfig] = None
    num_filters: int = 0


@dataclass
class LayerInputConfig(Message):
    input_layer_name: str = ""
    input_parameter_name: str = ""
    conv_conf: Optional[ConvConfig] = None
    pool_conf: Optional[PoolConfig] = None
    norm_conf: Optional[NormConfig] = None
    proj_conf: Optional[ProjectionConfig] = None
    block_expand_conf: Optional[BlockExpandConfig] = None
    image_conf: Optional[ImageConfig] = None
    input_layer_argument: str = ""


@dataclass
class LayerConfig(Message):
    # ref: ModelConfig.proto.m4 LayerConfig:229 (~90 fields; the ones demos
    # and config_parser actually set)
    name: str = ""
    type: str = ""
    size: int = 0
    active_type: str = ""
    inputs: List[LayerInputConfig] = field(default_factory=list)
    bias_parameter_name: str = ""
    num_filters: int = 0
    shared_biases: bool = False
    partial_sum: int = 1
    drop_rate: float = 0.0
    num_classes: int = 0
    device: int = -1
    reversed: bool = False
    active_gate_type: str = ""
    active_state_type: str = ""
    num_neg_samples: int = 10
    neg_sampling_dist: List[float] = field(default_factory=list)
    output_max_index: bool = False
    softmax_selfnorm_alpha: float = 0.1
    directions: List[bool] = field(default_factory=list)
    norm_by_times: bool = False
    coeff: float = 1.0
    average_strategy: str = "average"
    error_clipping_threshold: float = 0.0
    operator_confs: List[OperatorConfig] = field(default_factory=list)
    NDCG_num: int = 0
    max_sort_size: int = -1
    slope: float = 1.0
    intercept: float = 0.0
    cos_scale: float = 1.0
    data_norm_strategy: str = ""
    bos_id: int = 0
    eos_id: int = 0
    beam_size: int = 0
    select_first: bool = False
    trans_type: str = "non-seq"
    selective_fc_pass_generation: bool = False
    has_selected_colums: bool = True
    selective_fc_full_mul_ratio: float = 0.02
    use_global_stats: bool = False
    moving_average_fraction: float = 0.9
    # TPU extensions (no 2016 counterpart): multi-head attention + context
    # parallelism knobs (paddle_tpu/layers/attention.py)
    num_heads: int = 0
    causal_attention: bool = False
    seq_parallel_mode: str = ""   # "" | ring | alltoall


@dataclass
class EvaluatorConfig(Message):
    name: str = ""
    type: str = ""
    input_layers: List[str] = field(default_factory=list)
    chunk_scheme: str = ""
    num_chunk_types: int = 0
    classification_threshold: float = 0.5
    positive_label: int = -1
    dict_file: str = ""
    result_file: str = ""
    num_results: int = 1
    delimited: bool = True


@dataclass
class LinkConfig(Message):
    layer_name: str = ""
    link_name: str = ""
    has_subseq: bool = False


@dataclass
class MemoryConfig(Message):
    layer_name: str = ""
    link_name: str = ""
    boot_layer_name: str = ""
    boot_bias_parameter_name: str = ""
    boot_bias_active_type: str = ""
    boot_with_const_id: int = -1
    is_sequence: bool = False


@dataclass
class GeneratorConfig(Message):
    max_num_frames: int = 0
    eos_layer_name: str = ""
    num_results_per_sample: int = 1
    beam_size: int = 1
    log_prob: bool = True
    # TPU extension: where the gen job writes results and the id→word dict
    # (the reference demos thread these through shell flags instead).
    result_file: str = ""
    dict_file: str = ""
    # data slot whose ids tag each sample in the result file (beam_search
    # id_input; empty = sequential indices)
    id_input_layer: str = ""


@dataclass
class SubModelConfig(Message):
    name: str = ""
    layer_names: List[str] = field(default_factory=list)
    input_layer_names: List[str] = field(default_factory=list)
    output_layer_names: List[str] = field(default_factory=list)
    evaluator_names: List[str] = field(default_factory=list)
    is_recurrent_layer_group: bool = False
    reversed: bool = False
    memories: List[MemoryConfig] = field(default_factory=list)
    in_links: List[LinkConfig] = field(default_factory=list)
    out_links: List[LinkConfig] = field(default_factory=list)
    generator: Optional[GeneratorConfig] = None
    # TPU extension: whole-value (non-scattered) inputs to the group —
    # the reference encodes these as ScatterAgent "real layers" at runtime;
    # making them explicit keeps the config self-describing.
    static_links: List[LinkConfig] = field(default_factory=list)


@dataclass
class ModelConfig(Message):
    # ref: ModelConfig.proto.m4 ModelConfig:457
    type: str = "nn"
    layers: List[LayerConfig] = field(default_factory=list)
    parameters: List[ParameterConfig] = field(default_factory=list)
    input_layer_names: List[str] = field(default_factory=list)
    output_layer_names: List[str] = field(default_factory=list)
    evaluators: List[EvaluatorConfig] = field(default_factory=list)
    sub_models: List[SubModelConfig] = field(default_factory=list)


# --------------------------------------------------------------------- data


@dataclass
class DataConfig(Message):
    # ref: DataConfig.proto.m4
    type: str = ""
    files: str = ""
    buffer_capacity: int = 0
    train_sample_num: int = -1
    async_load_data: bool = False
    for_test: bool = False
    constant_slots: List[float] = field(default_factory=list)
    load_data_module: str = ""
    load_data_object: str = ""
    load_data_args: str = ""
    data_ratio: int = 1
    is_main_data: bool = True
    usage_ratio: float = 1.0
    # ref: DataConfig.proto.m4 sub_data_configs (MultiDataProvider)
    sub_data_configs: List["DataConfig"] = field(default_factory=list)


# ----------------------------------------------------------------- trainer


@dataclass
class OptimizationConfig(Message):
    # ref: TrainerConfig.proto.m4 OptimizationConfig:20-129
    batch_size: int = 1
    algorithm: str = "sgd"
    num_batches_per_send_parameter: int = 1
    num_batches_per_get_parameter: int = 1
    learning_rate: float = 1.0
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_schedule: str = "constant"
    learning_rate_args: str = ""
    l1weight: float = 0.1
    l2weight: float = 0.0
    l2weight_zero_iter: int = 0
    # whole-data batch algorithms (algorithm=owlqn; config_parser.py
    # settings c1/backoff/owlqn_steps/max_backoff)
    c1: float = 0.0001
    backoff: float = 0.5
    owlqn_steps: int = 10
    max_backoff: int = 5
    average_window: float = 0.0
    max_average_window: int = MAX_I64
    do_average_in_cpu: bool = False
    learning_method: str = "momentum"
    ada_epsilon: float = 1e-6
    ada_rou: float = 0.95
    delta_add_rate: float = 1.0
    shrink_parameter_value: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    async_lagged_grad_discard_ratio: float = 1.5
    use_sparse_remote_updater: bool = False
    # TPU extensions
    gradient_clipping_threshold: float = 0.0
    dtype: str = "float32"       # compute dtype for activations: float32|bfloat16
    mesh_shape: str = ""         # e.g. "data=8" / "data=4,model=2"
    # rematerialization: "none" stores all activations for backward;
    # "full" wraps the loss in jax.checkpoint so backward recomputes the
    # forward — trades ~33% more FLOPs for O(1) activation memory, the
    # HBM lever for big models/long sequences (SURVEY.md: jax.checkpoint)
    remat: str = "none"          # none|full
    # lax.scan unroll factor for recurrent layers / recurrent groups:
    # unrolling k steps per scan iteration lets XLA pipeline the per-step
    # MXU matmuls and amortize loop overhead, at k× program size. 1 = off.
    scan_unroll: int = 1
    # run lstmemory/gated_recurrent layers through the fused Pallas
    # sequence kernels
    # (ops/pallas_lstm.py): whole time scan in one kernel launch, carry +
    # recurrent weight resident in VMEM. Off by default until measured
    # faster on the target chip; layers fall back to lax.scan for
    # unsupported shapes/activations either way.
    pallas_rnn: bool = False
    # transpose-free interface for the fused Pallas sequence kernels:
    # the kernel reads the projection output's batch-major value through
    # a free [B, T*width] reshape instead of a materialized time-major
    # swap (layers/recurrent.py _pallas_rnn_path). A/B knob beside
    # pallas_rnn; the PADDLE_TPU_PALLAS_FLAT=1 env var still forces it
    # on for configs that can't be edited. Flip the default only on a
    # measured win.
    pallas_flat: bool = False
    # space-to-depth rewrite of few-channel 7x7/s2 stem convs (ResNet
    # conv1) into an MXU-friendly 4x4/s1 conv over a 2x2-block view —
    # exact arithmetic, summation order aside (layers/vision.py
    # _stem_s2d_conv). Off by default until measured on the target chip.
    conv_s2d: bool = False
    # fused 1x1-conv + batch-norm statistics, to eliminate the BN stats
    # pass's full re-read of the conv output from HBM (30.7% of the
    # measured ResNet-50 bf16 step). Two modes:
    #  - "gram": compute sum/sumsq of y = x@w + b from the INPUT side
    #    (colsum(x)@w and w^T(x^Tx)w, exact algebra) — pure XLA, keeps
    #    every conv layout/fusion, applied when N >= 2K so the two x
    #    reads beat the saved y read (layers/vision.py).
    #  - "pallas": the ops/pallas_conv1x1_bn kernel accumulates stats in
    #    the matmul epilogue. Measured END-TO-END LOSER on v5e
    #    (2026-08-01: 1272 vs 2220 imgs/s): XLA lays conv outputs
    #    batch-near-minor and the kernel's row-major [M,K] interface
    #    forces ~33% of the step into relayout copies. Kept for A/B.
    #  - "": off (default until a measured win).
    conv_stats_mode: str = ""
    # run a matching attention-GRU decoder recurrent group (the seqToseq
    # template) as ONE fused Pallas launch per train step, encoder
    # states VMEM-resident per batch block (ops/pallas_attention_gru,
    # graph/fused_decoder.py). Off by default until measured faster on
    # the target chip; non-matching groups take the lax.scan either way.
    pallas_decoder: bool = False
    # fuse k consecutive same-shape batches into ONE device launch
    # (lax.scan over stacked batches): amortizes per-dispatch host latency
    # when single steps are short — each batch still gets its own optimizer
    # update, so numerics match k=1. 1 = off. See doc/performance.md.
    batches_per_launch: int = 1


@dataclass
class TrainerConfig(Message):
    # ref: TrainerConfig.proto.m4 TrainerConfig:132
    model_config: ModelConfig = field(default_factory=ModelConfig)
    data_config: Optional[DataConfig] = None
    opt_config: OptimizationConfig = field(default_factory=OptimizationConfig)
    test_data_config: Optional[DataConfig] = None
    config_files: List[str] = field(default_factory=list)
    save_dir: str = "./output/model"
    init_model_path: str = ""
    start_pass: int = 0
