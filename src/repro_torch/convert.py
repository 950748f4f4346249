"""Carry state across from the reference package, duck-typed on field names.

The port never imports the reference package; these helpers take any object
(or dict) with the reference's field names and numpy-convertible values and
rebuild the port's types, so a test can hand both packages one input.

For the model substrate, ``reference_params_numpy`` draws a parameter tree
in the reference's layout from numpy (the two frameworks' generators give
different numbers from one seed, so this is the only way to give both the
same weights), ``params_from_numpy`` loads such a tree into the port's
model and ``params_to_numpy`` takes the model's parameters (or any tensors
named as them, such as their gradients) back out in the reference's
layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.mcg import MCG
from .device import resolve_device
from .models import layers as L
from .models import transformer as T
from .core.routing import Mesh2D
from .core.simulator import SimResult
from .kernels.sketch_update.ref import DRAIN_KEYS, STATE_KEYS


def _to_torch(d, keys, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(d[k])).to(device) for k in keys}


def _to_numpy(d, keys) -> dict[str, np.ndarray]:
    return {k: d[k].detach().cpu().numpy() for k in keys}


def sketch_state_from_numpy(d, device="cpu") -> dict[str, torch.Tensor]:
    """A ``make_state`` dict of arrays (same keys and dtypes) → tensors."""
    return _to_torch(d, STATE_KEYS, device)


def sketch_state_to_numpy(state) -> dict[str, np.ndarray]:
    return _to_numpy(state, STATE_KEYS)


def drain_from_numpy(d, device="cpu") -> dict[str, torch.Tensor]:
    """A ``make_drain`` dict of arrays → tensors."""
    return _to_torch(d, DRAIN_KEYS, device)


def drain_to_numpy(drain) -> dict[str, np.ndarray]:
    return _to_numpy(drain, DRAIN_KEYS)


def sim_result_from_numpy(obj) -> SimResult:
    """Any object with ``SimResult``'s fields → the port's ``SimResult``
    (arrays copied)."""
    return SimResult(
        total_time=float(obj.total_time),
        comp={k: np.array(v) for k, v in obj.comp.items()},
        comm={k: np.array(v) for k, v in obj.comm.items()},
        n_raw_records=int(obj.n_raw_records))


def mcg_from_numpy(obj) -> MCG:
    """Any object with ``MCG``'s fields on a W×H mesh → the port's ``MCG``
    on the port's ``Mesh2D`` of the same width and height."""
    return MCG(
        mesh=Mesh2D(int(obj.mesh.width), int(obj.mesh.height)),
        n_windows=int(obj.n_windows), n_nodes=int(obj.n_nodes),
        edge_src=np.array(obj.edge_src), edge_dst=np.array(obj.edge_dst),
        edge_w=np.array(obj.edge_w),
        edge_link_path=[list(map(int, p)) for p in obj.edge_link_path],
        s0=np.array(obj.s0), l0=np.array(obj.l0),
        node_window=np.array(obj.node_window))


def reference_params_numpy(cfg, seed: int) -> dict:
    """The reference's parameter pytree (``transformer.init_model``'s
    nested dicts, period-stacked leaves with a leading ``n_periods`` axis,
    an encoder-decoder's ``encoder`` leaves with a leading
    ``n_enc_layers`` axis) as f32 numpy arrays drawn from
    ``np.random.default_rng(seed)`` at the init scales of
    ``transformer.param_spec``, the table ``init_model`` draws from too."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def leaves(lead):
        def draw(leaf):
            shape = lead + leaf.shape
            if leaf.std is not None:
                return rng.standard_normal(shape, dtype=f32) * f32(leaf.std)
            return np.broadcast_to(np.asarray(leaf.fill, f32), shape).copy()
        return draw

    spec = T.param_spec(cfg)
    periods = spec.pop("periods")
    encoder = spec.pop("encoder", None)
    tree = L.map_leaves(leaves(()), spec)
    tree["periods"] = L.map_leaves(leaves((T.n_periods(cfg),)), periods)
    if encoder is not None:
        tree["encoder"] = L.map_leaves(leaves((cfg.n_enc_layers,)), encoder)
    return tree


def params_from_numpy(cfg, tree, device=None,
                      dtype=torch.float32) -> T.Model:
    """The reference's parameter pytree (numpy-convertible f32 leaves, with
    the leading period axis) → the port's
    :class:`~.models.transformer.Model` on ``device`` (default ``cuda:0``),
    each leaf stored in ``dtype`` by the rule of ``init_model``
    (``layers.leaf_dtype``: the leaves the reference keeps in f32 stay
    f32), rounded to nearest even as ``astype`` rounds.  Layer
    ``p * period_len + i`` takes period ``p`` of ``periods/slot{i}``;
    encoder layer ``j`` takes entry ``j`` of every ``encoder`` leaf."""
    dev = resolve_device(device)
    spec = T.param_spec(cfg)

    def tensor(a, leaf):
        # a copy: training updates the parameters in place, and the
        # caller's arrays (which another framework may alias) stay as given
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(L.leaf_dtype(leaf, dtype)).to(dev)

    def block(leaves, specs, pi=None):
        return L.ParamBlock({k: tensor(v if pi is None else v[pi], specs[k])
                             for k, v in leaves.items()})

    def layer(blocks, specs, i):
        return torch.nn.ModuleDict({name: block(leaves, specs[name], i)
                                    for name, leaves in blocks.items()})

    pl = T.period_len(cfg)
    layers = [layer(tree["periods"][f"slot{li % pl}"],
                    spec["periods"][f"slot{li % pl}"], li // pl)
              for li in range(T.n_periods(cfg) * pl)]
    lm_head = tree.get("lm_head")
    encoder = enc_norm = None
    if cfg.enc_dec:
        encoder = [layer(tree["encoder"], spec["encoder"], j)
                   for j in range(cfg.n_enc_layers)]
        enc_norm = block(tree["enc_final_norm"], spec["enc_final_norm"])
    return T.Model(cfg, tensor(tree["embed"], spec["embed"]),
                   block(tree["final_norm"], spec["final_norm"]), layers,
                   None if lm_head is None
                   else tensor(lm_head, spec["lm_head"]), encoder, enc_norm)


def params_to_numpy(cfg, model, tensors=None) -> dict:
    """The reverse of :func:`params_from_numpy`: the model's parameters
    as the reference's pytree of f32 numpy arrays (nested dicts,
    ``periods/slot{i}`` leaves stacked over periods, ``encoder`` leaves
    over encoder layers; a bf16 leaf comes back as the f32 number it
    holds, exactly).  ``tensors``, a ``{parameter name: tensor}`` dict
    (for example each parameter's ``grad``), is laid out in their
    place."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    pl = T.period_len(cfg)
    tree: dict = {}
    stacked: dict = {}
    for name, _ in model.named_parameters():
        arr = tensors[name].detach().cpu().float().numpy()
        parts = name.split(".")
        if parts[0] in ("layers", "encoder"):
            li = int(parts[1])
            key = (("periods", f"slot{li % pl}") if parts[0] == "layers"
                   else ("encoder",)) + tuple(parts[2:])
            stacked.setdefault(key, []).append(arr)
            continue
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = arr
    for key, arrs in stacked.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.stack(arrs)
    return tree
