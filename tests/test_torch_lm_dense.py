"""The port's LM serving path against the JAX package: the dense,
vision-language and audio families (granite-3-2b, gemma3's local/global
windows, starcoder2, granite-34b's MQA, llava's prepended patches, hubert's
encoder).  Each ``SMOKE`` configuration's ``forward_logits``, ``prefill`` and
``decode_step`` match the reference's within its bf16 tolerance, and 8
greedy ``LMEngine`` tokens equal the reference engine's (see
``torch_lm_cases``)."""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtfm
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import LMEngine
from torch_lm_cases import (GEN, PROMPT, check_forward, check_generate,
                            check_prefill_decode, jax_case, make_batch, port_engine,
                            prompt_batch)

ARCHS = ["granite-3-2b", "gemma3-27b", "starcoder2-3b", "granite-34b", "llava-next-34b",
         "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_jax(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_generate_matches_jax(arch):
    check_generate(arch)


def test_encoder_only_generate_raises_like_jax():
    """hubert has no decode: the reference's engine prefills, then its decode
    step reads ``params["embed"]``, which an audio model lacks; the port
    raises the same KeyError."""
    from repro.serve.engine import LMEngine as JaxLMEngine

    jcfg, jp, _ = jax_case("hubert-xlarge")
    batch = make_batch(jcfg, s=PROMPT)
    with pytest.raises(KeyError, match="embed"):
        JaxLMEngine(jcfg, jp, max_seq=PROMPT + 2).generate(
            {k: jax.numpy.asarray(v) for k, v in batch.items()}, 2)
    with pytest.raises(KeyError, match="embed"):
        port_engine("hubert-xlarge", PROMPT + 2).generate(batch, 2)


def test_sampled_generate_is_held_to_its_seed():
    cfg = smoke_config("granite-3-2b")
    eng = port_engine("granite-3-2b", PROMPT + GEN)
    batch = prompt_batch(cfg)
    a = eng.generate(batch, GEN, temperature=1.0, seed=3)
    b = eng.generate(batch, GEN, temperature=1.0, seed=3)
    c = eng.generate(batch, GEN, temperature=1.0, seed=4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_takes_the_jax_tree(arch):
    """Every leaf carried across as float32, equal to the JAX leaf; the
    port's own ``init_params`` gives the same tree of shapes."""
    cfg = smoke_config(arch)
    _, _, tree = jax_case(arch)
    params = tfm.params_from_numpy(cfg, tree, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    drawn = tfm.init_params(cfg, 0, device="cpu")
    shapes = tfm.tree_map(lambda a: tuple(a.shape), drawn)
    assert shapes == tfm.tree_map(lambda a: tuple(a.shape), params)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jtfm.param_shapes(jax_case(arch)[0]),
                                  is_leaf=lambda a: hasattr(a, "shape"))


def test_params_from_numpy_rejects_another_tree():
    cfg = smoke_config("granite-3-2b")
    _, _, tree = jax_case("granite-3-2b")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        tfm.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        tfm.params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "embed"},
                              device="cpu")


def test_init_params_is_held_to_its_seed():
    cfg = smoke_config("gemma3-27b")
    a = tfm.init_params(cfg, 5, device="cpu")
    b = tfm.init_params(cfg, 5, device="cpu")
    c = tfm.init_params(cfg, 6, device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])
    # bf16 matmul weights once, float32 norms
    p = tfm.cast_matmul_weights(a)
    assert p["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["blocks"]["ln1"].dtype == torch.float32 and p["final_norm"].dtype == torch.float32


def test_engine_and_init_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMEngine(cfg, tfm.init_params(cfg, 0, device="cpu"))
