"""The port's model stack against the JAX reference, on the CPU.

Both packages get one set of weights: ``reference_params_numpy`` draws the
reference's parameter tree from numpy, the reference runs it as jnp arrays
and the port loads it with ``params_from_numpy``.  Mirrors
``test_models.py:71-92`` (``test_prefill_decode_equivalence``) at its
2e-4: ``forward_train`` logits, the prefill's last-position logits and one
``decode_step`` agree with the reference for smollm-135m (dense, GQA, tied
embeddings), mamba2-1.3b (SSD), h2o-danube-3-4b (sliding window: the
prefill overruns the 16-slot rolling cache), stablelm-1.6b (LayerNorm),
mixtral-8x7b and dbrx-132b (mixture of experts; the ``forward_train`` aux
loss too), qwen2-vl-2b (M-RoPE) and jamba-1.5-large-398b (attention, Mamba
and MoE layers in one period) smoke configs.  Also: the configs are the reference's, ``init_model``'s
parameter shapes are the reference's (``jax.eval_shape``) and its init
scales too (as are ``reference_params_numpy``'s), and the layers
match one by one.  The encoder-decoder (whisper) has its own file,
``test_torch_whisper.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_numpy, reference_params_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["smollm-135m", "mamba2-1.3b", "h2o-danube-3-4b", "stablelm-1.6b",
         "mixtral-8x7b", "dbrx-132b", "qwen2-vl-2b", "jamba-1.5-large-398b"]


def _close(got, exp, tol=2e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               atol=tol, rtol=tol)


def test_configs_are_the_reference_configs():
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        for smoke in (False, True):
            ours, ref = get_config(arch, smoke), j_get_config(arch, smoke)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.param_count() == ref.param_count()


def _port_leaves(cfg, model):
    """The port's parameters as numpy, keyed as the reference's tree
    (``jax.tree_util.keystr``), each period leaf stacked over periods."""
    pl = T.period_len(cfg)
    got = {}
    for name, prm in model.named_parameters():
        assert prm.dtype == torch.float32 and prm.requires_grad, name
        parts = name.split(".")
        if parts[0] == "layers":
            parts = ["periods", f"slot{int(parts[1]) % pl}", *parts[2:]]
        got.setdefault("".join(f"['{k}']" for k in parts), []).append(
            prm.detach().numpy())
    return {k: np.stack(v) if k.startswith("['periods']") else v[0]
            for k, v in got.items()}


def _ref_leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_shapes_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    ref = jax.eval_shape(lambda: JT.init_model(
        j_get_config(arch, smoke=True), jax.random.PRNGKey(0),
        dtype=jnp.float32))
    exp = {jax.tree_util.keystr(path): (tuple(leaf.shape), leaf.dtype)
           for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    got = _port_leaves(cfg, T.init_model(cfg, torch.Generator().manual_seed(0),
                                         dtype=torch.float32))
    assert {k: v.shape for k, v in got.items()} == {
        k: s for k, (s, _) in exp.items()}
    assert {str(dt) for _, dt in exp.values()} == {"float32"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_scales_match_reference(arch):
    """``init_model`` and ``reference_params_numpy`` (one table of init
    scales) against the reference's ``init_model``: the leaves that do not
    depend on the key (norms, biases, ``a_log``, ``d_skip``) are equal, and
    the random ones have the reference's mean and std."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    ref0, ref1 = (_ref_leaves(JT.init_model(jcfg, jax.random.PRNGKey(k),
                                            dtype=jnp.float32))
                  for k in (0, 1))
    ours = _port_leaves(cfg, T.init_model(cfg, torch.Generator().manual_seed(0),
                                          dtype=torch.float32))
    npy = _ref_leaves(reference_params_numpy(cfg, 0))
    assert ours.keys() == npy.keys() == ref0.keys()
    for key, want in ref0.items():
        for got in (ours[key], npy[key]):
            assert got.shape == want.shape and got.dtype == np.float32, key
            if np.array_equal(want, ref1[key]):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
            else:
                tol = 5 / np.sqrt(want.size)
                assert abs(got.std() / want.std() - 1) < tol, key
                assert abs(got.mean() - want.mean()) < 2 * tol * want.std(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    jcfg = j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, seed=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    tt, tn = torch.from_numpy(tokens), torch.from_numpy(nxt)

    logits, aux = T.forward_train(cfg, model, tt)
    jlogits, jaux = JT.forward_train(jcfg, jparams, jnp.asarray(tokens))
    assert (float(aux.detach()) == 0.0) == (cfg.n_experts == 0)
    _close(aux, jaux)
    _close(logits, jlogits)

    cache = T.init_cache(cfg, 2, 64, device="cpu", dtype=torch.float32)
    last, cache, memory = T.prefill(cfg, model, tt, cache)
    assert memory is None
    jcache = JT.init_cache(jcfg, 2, 64, dtype=jnp.float32)
    jlast, jcache, _ = JT.prefill(jcfg, jparams, jnp.asarray(tokens), jcache)
    _close(last, jlast)
    _close(last[:, 0], logits[:, -1].detach().numpy())

    dec, _ = T.decode_step(cfg, model, tn, cache, 24)
    jdec, _ = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(24))
    _close(dec, jdec)
    full, _ = T.forward_train(cfg, model, torch.cat([tt, tn], 1))
    _close(dec[:, 0], full[:, -1].detach().numpy())


@pytest.mark.parametrize("norm,act", [("rms", "swiglu"), ("ln", "gelu")])
def test_layers_match_reference(norm, act):
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True),
                              norm=norm, mlp=act)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(2))
    w = {k: (rng.standard_normal(shape) * 0.1).astype(np.float32)
         for k, shape in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                          ("w_down", (96, 64)))}
    if act == "gelu":
        del w["w_gate"]
    tx = torch.from_numpy(x)
    norm_p = TL.ParamBlock({"scale": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)})
    _close(TL.apply_norm(cfg, tx, norm_p),
           JL.apply_norm(cfg, jnp.asarray(x), {"scale": scale, "bias": bias}),
           tol=1e-5)
    mlp_p = TL.ParamBlock({k: torch.from_numpy(v) for k, v in w.items()})
    _close(TL.mlp(cfg, mlp_p, tx), JL.mlp(cfg, w, jnp.asarray(x)), tol=1e-5)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4), tol=1e-4)
