"""The model builders of the port: the seqToseq NMT model, the LSTM text
classifier, ResNet, the long-context causal LM and the hierarchical
document classifier over nested sequences.

:func:`gru_encoder_decoder` is this package's copy of
``demo/seqToseq/seqToseq_net.py`` (bidirectional GRU encoder, Bahdanau
attention, GRU decoder), and :func:`flagship_config` the JAX package's
stacked-LSTM classifier (``paddle_tpu.flagship.flagship_config``) and
:func:`resnet_config` a copy of ``demo/model_zoo/resnet/resnet.py`` and
:func:`long_context_config` one of ``demo/long_context/trainer_config.py``, all
written against ``paddle_tpu_torch.trainer_config_helpers``, so the same
DSL builds the same ``ModelConfig`` as the JAX package's builders. The
batch builders draw from numpy with the JAX package's draws, so both
packages see the same batch.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.config.builder import fresh_context
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.trainer_config_helpers import (
    AdamOptimizer,
    AvgPooling,
    GeneratedInput,
    L2Regularization,
    LinearActivation,
    MaxPooling,
    MomentumOptimizer,
    ParamAttr,
    ReluActivation,
    SoftmaxActivation,
    StaticInput,
    SubsequenceInput,
    TanhActivation,
    addto_layer,
    batch_norm_layer,
    beam_search,
    classification_cost,
    concat_layer,
    data_layer,
    embedding_layer,
    fc_layer,
    first_seq,
    full_matrix_projection,
    gru_group,
    gru_step_layer,
    img_conv_layer,
    img_pool_layer,
    last_seq,
    lstmemory,
    memory,
    mixed_layer,
    multi_head_attention_layer,
    outputs,
    pooling_layer,
    recurrent_group,
    settings,
    simple_attention,
    simple_gru,
    simple_lstm,
)


def gru_encoder_decoder(source_dict_dim, target_dict_dim, is_generating,
                        word_vector_dim=512, encoder_size=512, decoder_size=512,
                        beam_size=3, max_length=250, bos_id=0, eos_id=1,
                        gen_result="gen_result.txt", gen_dict=None):
    src_word_id = data_layer(name="source_language_word", size=source_dict_dim)
    src_embedding = embedding_layer(
        input=src_word_id, size=word_vector_dim,
        param_attr=ParamAttr(name="_source_language_embedding"))
    src_forward = simple_gru(input=src_embedding, size=encoder_size)
    src_backward = simple_gru(input=src_embedding, size=encoder_size, reverse=True)
    encoded_vector = concat_layer(input=[src_forward, src_backward])

    with mixed_layer(size=decoder_size) as encoded_proj:
        encoded_proj += full_matrix_projection(encoded_vector)

    backward_first = first_seq(input=src_backward)
    with mixed_layer(size=decoder_size, act=TanhActivation()) as decoder_boot:
        decoder_boot += full_matrix_projection(backward_first)

    def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
        decoder_mem = memory(name="gru_decoder", size=decoder_size, boot_layer=decoder_boot)
        context = simple_attention(
            encoded_sequence=enc_vec, encoded_proj=enc_proj, decoder_state=decoder_mem)
        with mixed_layer(size=decoder_size * 3) as decoder_inputs:
            decoder_inputs += full_matrix_projection(context)
            decoder_inputs += full_matrix_projection(current_word)
        gru_step = gru_step_layer(
            name="gru_decoder", input=decoder_inputs, output_mem=decoder_mem,
            size=decoder_size)
        with mixed_layer(size=target_dict_dim, bias_attr=True,
                         act=SoftmaxActivation()) as out:
            out += full_matrix_projection(input=gru_step)
        return out

    decoder_group_name = "decoder_group"
    if not is_generating:
        trg_embedding = embedding_layer(
            input=data_layer(name="target_language_word", size=target_dict_dim),
            size=word_vector_dim,
            param_attr=ParamAttr(name="_target_language_embedding"))
        decoder = recurrent_group(
            name=decoder_group_name, step=gru_decoder_with_attention,
            input=[StaticInput(input=encoded_vector, is_seq=True),
                   StaticInput(input=encoded_proj, is_seq=True),
                   trg_embedding])
        lbl = data_layer(name="target_language_next_word", size=target_dict_dim)
        outputs(classification_cost(input=decoder, label=lbl))
    else:
        trg_embedding = GeneratedInput(
            size=target_dict_dim, embedding_name="_target_language_embedding",
            embedding_size=word_vector_dim)
        beam_gen = beam_search(
            name=decoder_group_name, step=gru_decoder_with_attention,
            input=[StaticInput(input=encoded_vector, is_seq=True),
                   StaticInput(input=encoded_proj, is_seq=True),
                   trg_embedding],
            bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
            max_length=max_length, dict_file=gen_dict, result_file=gen_result)
        outputs(beam_gen)


def nmt_config(vocab=30000, dim=512, dtype="float32", batch_size=64,
               is_generating=False, **gen_kwargs):
    """seqToseq NMT attention encoder-decoder (the JAX package's
    ``flagship.nmt_config``); ``is_generating=True`` builds the generation
    graph, with ``gen_kwargs`` (beam_size, max_length, ...) passed through."""
    with fresh_context() as ctx:
        settings(batch_size=batch_size, learning_rate=1e-3,
                 learning_method=AdamOptimizer(), dtype=dtype)
        gru_encoder_decoder(
            source_dict_dim=vocab, target_dict_dim=vocab,
            is_generating=is_generating, word_vector_dim=dim,
            encoder_size=dim, decoder_size=dim, **gen_kwargs)
        return ctx.finalize()


def nmt_gen_config(vocab=30000, dim=512, beam_size=3, max_length=32,
                   dtype="float32", batch_size=64):
    """The seqToseq generation graph (see :func:`nmt_config`)."""
    return nmt_config(vocab=vocab, dim=dim, dtype=dtype, batch_size=batch_size,
                      is_generating=True, beam_size=beam_size,
                      max_length=max_length)


def nmt_gen_batch(vocab=30000, B=8, T=32, seed=0, device: DeviceLike = None):
    """Source-only batch for the generation graph, from ``seed``."""
    from paddle_tpu_torch.graph import make_seq
    from paddle_tpu_torch.device import resolve_device

    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, (B, T)).astype(np.int32)
    lengths = rng.randint(max(T // 2, 1), T + 1, (B,)).astype(np.int32)
    return {"source_language_word": make_seq(None, lengths, ids=ids,
                                             device=resolve_device(device))}


def nmt_gen_spread_params(params, model_config, out_scale=8.0):
    """A copy of a generation model's parameters whose next-word
    distribution is spread as a trained model's: both embedding tables
    scaled to unit variance (smart init draws them at 1/sqrt(vocab)) and
    the output layer's weights times ``out_scale``. At vocab 30000 and
    dim 512 the log-probabilities then spread by ~3 (std), where at
    ``init_params``' scale each lies within ~2e-5 of -ln(vocab), so that
    any choice of tokens scores alike."""
    out = dict(params)
    for name in ("_source_language_embedding", "_target_language_embedding"):
        out[name] = params[name] * float(np.sqrt(params[name].shape[0]))
    sub = next(s for s in model_config.sub_models if s.generator is not None)
    score = next(l for l in model_config.layers if l.name == sub.out_links[0].layer_name)
    for inp in score.inputs:
        if inp.input_parameter_name:
            out[inp.input_parameter_name] = params[inp.input_parameter_name] * out_scale
    return out


def nmt_batch(vocab=30000, B=8, T=32, seed=0, device: DeviceLike = None):
    """A training batch for :func:`nmt_config`: source words, target words
    and the next-word labels, from ``seed`` with the JAX package's numpy
    draws (``paddle_tpu.flagship.nmt_batch``), so both packages see the
    same batch."""
    from paddle_tpu_torch.graph import make_seq
    from paddle_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def seq():
        ids = rng.randint(2, vocab, (B, T)).astype(np.int32)
        lengths = rng.randint(max(T // 2, 1), T + 1, (B,)).astype(np.int32)
        return ids, lengths

    src, src_len = seq()
    trg, trg_len = seq()
    nxt = np.roll(trg, -1, axis=1)
    return {
        "source_language_word": make_seq(None, src_len, ids=src, device=dev),
        "target_language_word": make_seq(None, trg_len, ids=trg, device=dev),
        "target_language_next_word": make_seq(None, trg_len, ids=nxt, device=dev),
    }


def flagship_config(dict_dim=1000, emb_dim=64, hidden=64, classes=2):
    """The stacked-LSTM text classifier (the sentiment-demo shape): word
    embedding, ``simple_lstm`` (the ``lstm_transform`` projection and one
    ``lstmemory``), max pooling over time, a softmax fc and
    ``classification_cost`` with its ``classification_error`` evaluator.
    Batch size 32 and Adam at lr 1e-3, as the JAX package's builder; set
    ``opt_config.batch_size`` for another batch."""
    with fresh_context() as ctx:
        settings(batch_size=32, learning_rate=1e-3, learning_method=AdamOptimizer())
        words = data_layer(name="words", size=dict_dim)
        emb = embedding_layer(input=words, size=emb_dim, param_attr=ParamAttr(name="emb"))
        lstm = simple_lstm(input=emb, size=hidden)
        pool = pooling_layer(input=lstm, pooling_type=MaxPooling())
        output = fc_layer(input=pool, size=classes, act=SoftmaxActivation(), name="output")
        label = data_layer(name="label", size=classes)
        outputs(classification_cost(input=output, label=label))
        return ctx.finalize()


def example_batch(dict_dim=1000, B=8, T=32, classes=2, seed=0, device: DeviceLike = None):
    """A classifier batch from ``seed``: word ids [B, T] with lengths in
    [T // 2, T] and one label per row (``paddle_tpu.flagship.example_batch``'s
    draws)."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.graph import make_ids, make_seq

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, dict_dim, (B, T)).astype(np.int32)
    lengths = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    labels = rng.randint(0, classes, (B,)).astype(np.int32)
    return {
        "words": make_seq(None, lengths, ids=ids, device=dev),
        "label": make_ids(labels, device=dev),
    }


RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv_bn(name, input, filter_size, num_filters, stride, padding, channels=None, act=None):
    """conv (no bias) + batch norm; ReLU unless ``act`` says otherwise."""
    conv = img_conv_layer(name=name, input=input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=channels, stride=stride,
                          padding=padding, act=LinearActivation(), bias_attr=False)
    return batch_norm_layer(name=name + "_bn", input=conv, act=act or ReluActivation())


def _bottleneck(name, input, mid_filters, out_filters, stride=1, project=False):
    """1x1 -> 3x3 -> 1x1 bottleneck with an identity or projection shortcut."""
    if project:
        shortcut = _conv_bn(name + "_proj", input, 1, out_filters, stride, 0,
                            act=LinearActivation())
    else:
        shortcut = input
    path = _conv_bn(name + "_a", input, 1, mid_filters, stride, 0)
    path = _conv_bn(name + "_b", path, 3, mid_filters, 1, 1)
    path = _conv_bn(name + "_c", path, 1, out_filters, 1, 0, act=LinearActivation())
    return addto_layer(name=name + "_sum", input=[shortcut, path], act=ReluActivation())


def _stage(name, input, blocks, mid_filters, out_filters, first_stride):
    tmp = _bottleneck(name + "_1", input, mid_filters, out_filters, stride=first_stride,
                      project=True)
    for i in range(2, blocks + 1):
        tmp = _bottleneck(f"{name}_{i}", tmp, mid_filters, out_filters)
    return tmp


def resnet_config(layer_num=50, img_size=224, classes=1000):
    """ResNet-50/101/152 for ImageNet: this package's copy of
    ``demo/model_zoo/resnet/resnet.py`` (the JAX package's
    ``flagship.resnet_config`` parses that file), with the demo's settings:
    batch size 64, Momentum 0.9 at lr 0.01/64, L2 0.0001*64. Its data
    provider is not part of the port yet: batches come from
    :func:`make_image_batch`."""
    stage_blocks = RESNET_STAGE_BLOCKS[layer_num]
    with fresh_context() as ctx:
        settings(batch_size=64, learning_rate=0.01 / 64.0,
                 learning_method=MomentumOptimizer(0.9),
                 regularization=L2Regularization(0.0001 * 64))
        img = data_layer(name="input", size=img_size * img_size * 3)
        tmp = _conv_bn("conv1", img, 7, 64, 2, 3, channels=3)
        tmp = img_pool_layer(name="pool1", input=tmp, pool_size=3, stride=2, padding=1,
                             pool_type=MaxPooling())
        widths = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
        for s, ((mid, out_w), blocks) in enumerate(zip(widths, stage_blocks), start=2):
            tmp = _stage(f"res{s}", tmp, blocks, mid, out_w, first_stride=1 if s == 2 else 2)
        tmp = img_pool_layer(name="global_pool", input=tmp, pool_size=tmp.img_size, stride=1,
                             pool_type=AvgPooling())
        output = fc_layer(name="output", input=tmp, size=classes, act=SoftmaxActivation())
        lbl = data_layer(name="label", size=classes)
        outputs(classification_cost(input=output, label=lbl))
        return ctx.finalize()


def make_image_batch(B, img_size, classes, seed=0, device: DeviceLike = None):
    """Images [B, 3 * img_size²] (flat NCHW) and labels from ``seed``, with
    the draws of ``paddle_tpu.flagship.make_image_batch``."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.graph import make_dense, make_ids

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    return {
        "input": make_dense(rng.randn(B, 3 * img_size * img_size).astype(np.float32),
                            device=dev),
        "label": make_ids(rng.randint(0, classes, (B,)).astype(np.int32), device=dev),
    }


def long_context_config(vocab=500, seq_len=256, dim=64, heads=4, blocks=2, batch_size=8,
                        dtype="float32"):
    """The long-context causal LM: this package's copy of
    ``demo/long_context/trainer_config.py`` on one device (no mesh), with
    its ``get_config_arg`` knobs as arguments. A token embedding, then
    ``blocks`` norm-free blocks of causal multi-head attention and a ReLU
    FFN with ``addto`` residuals, a softmax head and
    ``classification_cost``; Adam at lr 1e-3; ``dtype`` the compute type
    ("bfloat16": mixed precision, the flash kernels' bf16 instances on the
    card). ``seq_len`` is the demo provider's, and shapes nothing here:
    batches come from :func:`lm_batch`."""
    with fresh_context() as ctx:
        settings(batch_size=batch_size, learning_rate=1e-3,
                 learning_method=AdamOptimizer(), mesh_shape=None, dtype=dtype)
        words = data_layer(name="words", size=vocab)
        x = embedding_layer(input=words, size=dim, param_attr=ParamAttr(name="tok_emb"))
        for i in range(blocks):
            att = multi_head_attention_layer(input=x, num_heads=heads, causal=True,
                                             seq_parallel="", name=f"block{i}_att")
            x = addto_layer(input=[x, att], name=f"block{i}_res1", bias_attr=False)
            ffn = fc_layer(input=x, size=4 * dim, act=ReluActivation(), name=f"block{i}_ffn1")
            ffn = fc_layer(input=ffn, size=dim, act=LinearActivation(), name=f"block{i}_ffn2")
            x = addto_layer(input=[x, ffn], name=f"block{i}_res2", bias_attr=False)
        logits = fc_layer(input=x, size=vocab, act=SoftmaxActivation(), name="lm_head")
        next_words = data_layer(name="next_words", size=vocab)
        outputs(classification_cost(input=logits, label=next_words))
        return ctx.finalize()


def lm_batch(vocab=500, B=8, T=256, seed=0, device: DeviceLike = None):
    """A batch of the demo provider's planted-bigram language
    (``demo/long_context/dataprovider.py``), drawn with numpy from ``seed``:
    each successor lies in the 8-token window starting at (7 * token) %
    vocab. ``words`` are the first T tokens of each row, ``next_words`` the
    T that follow them; both full length."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.graph import make_seq

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    toks = np.empty((B, T + 1), np.int64)
    toks[:, 0] = rng.randint(vocab, size=B)
    offsets = rng.randint(8, size=(B, T))
    for t in range(T):
        toks[:, t + 1] = ((toks[:, t] * 7) % vocab + offsets[:, t]) % vocab
    lengths = np.full((B,), T, np.int32)
    return {
        "words": make_seq(None, lengths, ids=toks[:, :-1].astype(np.int32), device=dev),
        "next_words": make_seq(None, lengths, ids=toks[:, 1:].astype(np.int32), device=dev),
    }


def hierarchical_config(vocab=30000, emb_dim=128, hidden=512, lstm_size=128, classes=2):
    """The hierarchical document classifier over nested sequences (a
    document of sentences of words): a word embedding (the sentiment
    demo's ``emb_dim``), an outer ``recurrent_group`` over the sentences
    (``SubsequenceInput``) whose step projects a sentence's words to
    3 * ``hidden``, runs ``gru_group`` over them (its group form: a
    ``gru_step`` a word) and takes the last word's state, one vector a
    sentence; then an fc of 4 * ``lstm_size`` and a ReLU ``lstmemory``
    over the sentences (the sentiment demo's first stacked layer), the
    last sentence's state, a softmax fc and ``classification_cost``. Adam
    at lr 1e-3, batch size 4 (set ``opt_config.batch_size`` for another).
    Batches come from :func:`nested_doc_batch`."""
    with fresh_context() as ctx:
        settings(batch_size=4, learning_rate=1e-3, learning_method=AdamOptimizer())
        words = data_layer(name="words", size=vocab)
        emb = embedding_layer(input=words, size=emb_dim, name="emb",
                              param_attr=ParamAttr(name="_emb"))

        def sentence(sub):
            proj = mixed_layer(size=3 * hidden, name="sent_proj", input=[
                full_matrix_projection(sub, param_attr=ParamAttr(name="_sent_proj.w"))])
            gru = gru_group(input=proj, size=hidden, name="sent_gru")
            return last_seq(input=gru, name="sent_vec")

        sents = recurrent_group(step=sentence, input=SubsequenceInput(emb), name="doc")
        fc = fc_layer(input=sents, size=4 * lstm_size, act=LinearActivation(), name="doc_fc")
        lstm = lstmemory(input=fc, act=ReluActivation(), name="doc_lstm")
        last = last_seq(input=lstm, name="doc_last")
        out = fc_layer(input=last, size=classes, act=SoftmaxActivation(), name="output")
        outputs(classification_cost(input=out, label=data_layer(name="label", size=classes)))
        return ctx.finalize()


def nested_doc_batch(vocab=30000, B=64, max_sents=8, max_words=32, min_words=3, classes=2,
                     zipf=1.1, seed=0, device: DeviceLike = None):
    """A nested batch of documents for :func:`hierarchical_config`, drawn
    with numpy from ``seed``: each document has 1..``max_sents`` sentences
    of ``min_words``..``max_words`` words, the words Zipf(``zipf``) over
    the vocabulary; the first document's last sentence is empty (a
    sub-sequence of length 0 inside a sample's count). ``words`` is
    ids [B, S, T] with ``seq_lengths`` the sentence counts and
    ``sub_seq_lengths`` [B, S]; ``label`` one class a document."""
    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.graph import Argument, make_ids
    from paddle_tpu_torch.graph.argument import _tensor

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_sents = rng.randint(1, max_sents + 1, B).astype(np.int32)
    n_sents[0] = max(n_sents[0], 2)
    sub_lens = np.zeros((B, max_sents), np.int32)
    for b in range(B):
        sub_lens[b, :n_sents[b]] = rng.randint(min_words, max_words + 1, n_sents[b])
    sub_lens[0, n_sents[0] - 1] = 0
    ids = np.minimum(rng.zipf(zipf, size=(B, max_sents, max_words)) - 1, vocab - 1)
    ids = np.where(np.arange(max_words)[None, None, :] < sub_lens[:, :, None], ids, 0)
    return {
        "words": Argument(ids=_tensor(ids, torch.int32, dev),
                          seq_lengths=_tensor(n_sents, torch.int32, dev),
                          sub_seq_lengths=_tensor(sub_lens, torch.int32, dev)),
        "label": make_ids(rng.randint(0, classes, B).astype(np.int32), device=dev),
    }
