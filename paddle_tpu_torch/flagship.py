"""The seqToseq NMT model builders of the port.

:func:`gru_encoder_decoder` is this package's copy of
``demo/seqToseq/seqToseq_net.py`` (bidirectional GRU encoder, Bahdanau
attention, GRU decoder), written against
``paddle_tpu_torch.trainer_config_helpers``, so the same DSL builds the
same ``ModelConfig`` as the JAX package's ``flagship.nmt_config``.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.config.builder import fresh_context
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.trainer_config_helpers import (
    AdamOptimizer,
    GeneratedInput,
    ParamAttr,
    SoftmaxActivation,
    StaticInput,
    TanhActivation,
    beam_search,
    classification_cost,
    concat_layer,
    data_layer,
    embedding_layer,
    first_seq,
    full_matrix_projection,
    gru_step_layer,
    memory,
    mixed_layer,
    outputs,
    recurrent_group,
    settings,
    simple_attention,
    simple_gru,
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
