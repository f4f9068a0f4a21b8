"""The port's checkpoint format, ``tpulab_torch-ckpt-v1``.

``tpulab`` snapshots its train state with orbax, which the card's machine
does not have; the port writes its own format, and the two packages cannot
read each other's snapshots (there is no converter, as ``tpulab`` has none).
What they share is the config sidecar (:func:`write_sidecar`), so either
package's ``load_sidecar`` reads the other's.

Layout of a checkpoint directory::

    <ckpt_dir>/tpulab_config.json   the sidecar: {"model", "config", "tokenizer"}
    <ckpt_dir>/tokenizer.json       the copied BPE table, when the run had one
    <ckpt_dir>/<step>/state.pt      torch.save of {"params", "opt_state", "step"}
    <ckpt_dir>/<step>/meta.json     {"format", "step", "leaves": {key: {dtype, shape}}}

``state.pt`` is read with ``torch.load(weights_only=True)``.  Parameters are
keyed by ``tpulab``'s parameter-tree paths (``embed``, ``final_norm``,
``blocks/wq``, ...; a per-layer leaf stacked on axis 0, as
:meth:`Labformer.to_tree` gives it), never by a leaf's position.  The
optimizer state keeps its nesting (``optim.chain``'s lists, each
transform's dict); every per-leaf list in it (adam's ``mu`` and ``nu``,
the momentum trace) becomes a dict keyed by the same paths, and the host
counters (``count`` of ``scale_by_adam`` and ``scale_by_learning_rate``)
go in as they are, so a resumed schedule carries on where it stopped.

A snapshot is written to ``<step>.tmp/`` and renamed into place with
``os.replace``: a directory whose name is not an integer is never a
snapshot.  The newest ``MAX_TO_KEEP`` snapshots are kept.  A directory that
holds an orbax snapshot raises ``ValueError`` naming orbax; one with no
snapshot has ``latest_step() is None``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

FORMAT = "tpulab_torch-ckpt-v1"
STATE_FILE = "state.pt"
META_FILE = "meta.json"
SIDECAR = "tpulab_config.json"
MAX_TO_KEEP = 3  # tpulab/train.py's CheckpointManagerOptions(max_to_keep=3)
#: the file orbax writes into each of its step directories
ORBAX_MARKER = "_CHECKPOINT_METADATA"
_LEAVES = "__leaves__"


def _steps(ckpt_dir: str) -> Dict[int, str]:
    """step -> directory, for every integer-named directory under ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return {}
    out = {}
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.isdigit() and os.path.isdir(path):
            out[int(name)] = path
    return out


def snapshot_steps(ckpt_dir: str) -> List[int]:
    """The steps of the snapshots under ``ckpt_dir``, ascending.  Raises
    ``ValueError`` when a step directory is not in this format."""
    steps = _steps(ckpt_dir)
    for step, path in steps.items():
        if os.path.exists(os.path.join(path, ORBAX_MARKER)):
            raise ValueError(
                f"{ckpt_dir} holds an orbax checkpoint (step {step}, written by tpulab); "
                f"the port reads only its own format, {FORMAT}")
        meta = os.path.join(path, META_FILE)
        found = None
        if os.path.exists(meta):
            with open(meta) as f:
                found = json.load(f).get("format")
        if found != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} snapshot (format={found!r})")
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest snapshot's step, or None when there is none."""
    steps = snapshot_steps(ckpt_dir)
    return steps[-1] if steps else None


# ------------------------------------------------------------ encoding


def param_keys(model) -> List[Tuple[str, int]]:
    """``(path, tensor count)`` of each trainable leaf, in ``_flat(model)``'s
    order: a per-layer leaf holds one tensor per layer."""
    return [(name, len(ts)) for name, ts in model.trainable_leaves()]


def _tree_paths(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks/{k}": v for k, v in tree.get("blocks", {}).items()})
    return out


def _encode(state, layout: List[Tuple[str, int]], n_flat: int):
    """The optimizer state with each per-leaf list as a dict keyed by path."""
    if isinstance(state, dict):
        return {k: _encode(v, layout, n_flat) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        if len(state) == n_flat and all(isinstance(t, torch.Tensor) for t in state):
            leaves, i = {}, 0
            for name, n in layout:
                ts = [t.detach().cpu() for t in state[i:i + n]]
                leaves[name] = torch.stack(ts) if name.startswith("blocks/") else ts[0]
                i += n
            return {_LEAVES: leaves}
        return [_encode(v, layout, n_flat) for v in state]
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    return state


def _describe(tree, prefix: str, out: Dict[str, Any]) -> None:
    """meta.json's ``leaves``: every tensor's dtype and shape, by key."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = {"dtype": str(tree.dtype).removeprefix("torch."),
                       "shape": list(tree.shape)}
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _describe(v, f"{prefix}/{k}" if k != _LEAVES else prefix, out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _describe(v, f"{prefix}/{i}", out)


def _take(saved: torch.Tensor, like: torch.Tensor, key: str) -> torch.Tensor:
    if saved.dtype != like.dtype or tuple(saved.shape) != tuple(like.shape):
        raise ValueError(f"snapshot leaf {key} is {saved.dtype} {tuple(saved.shape)}; the "
                         f"live leaf is {like.dtype} {tuple(like.shape)}")
    return saved.to(like.device)


def _decode_into(live, saved, layout: List[Tuple[str, int]], n_flat: int, key: str) -> None:
    """Write ``saved`` into the live optimizer state: lists and dicts keep
    their identity, per-leaf tensors and counters are replaced."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"optimizer state at {key or '/'} differs from the snapshot's")
        for k in live:
            if isinstance(live[k], (dict, list)):
                _decode_into(live[k], saved[k], layout, n_flat, f"{key}/{k}")
            elif isinstance(live[k], torch.Tensor):
                live[k] = _take(saved[k], live[k], f"{key}/{k}")
            else:
                live[k] = saved[k]
        return
    if isinstance(live, list):
        if (len(live) == n_flat and all(isinstance(t, torch.Tensor) for t in live)
                and isinstance(saved, dict) and _LEAVES in saved):
            leaves, i = saved[_LEAVES], 0
            for name, n in layout:
                if name not in leaves:
                    raise ValueError(f"optimizer state at {key} lacks leaf {name}")
                for j in range(n):
                    t = leaves[name][j] if name.startswith("blocks/") else leaves[name]
                    live[i + j] = _take(t, live[i + j], f"{key}/{name}")
                i += n
            return
        if not isinstance(saved, list) or len(saved) != len(live):
            raise ValueError(f"optimizer state at {key or '/'} differs from the snapshot's")
        for i in range(len(live)):
            if isinstance(live[i], (dict, list)):
                _decode_into(live[i], saved[i], layout, n_flat, f"{key}/{i}")
            elif isinstance(live[i], torch.Tensor):
                live[i] = _take(saved[i], live[i], f"{key}/{i}")
            elif live[i] != saved[i]:
                raise ValueError(f"optimizer state at {key}/{i} differs from the snapshot's")
        return
    if live != saved:
        raise ValueError(f"optimizer state at {key or '/'} differs from the snapshot's")


# ------------------------------------------------------------ save and restore


def save(ckpt_dir: str, step: int, model, opt_state=None,
         max_to_keep: int = MAX_TO_KEEP) -> int:
    """Write ``<ckpt_dir>/<step>/`` from the model's parameters (all of
    them, frozen base leaves included) and ``opt_state``; keep the newest
    ``max_to_keep`` snapshots.  Returns the bytes written."""
    from tpulab_torch.models.labformer import _flat

    layout = param_keys(model)
    state = {"params": _tree_paths(model.to_tree()), "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = _encode(opt_state, layout, len(_flat(model)))
    leaves: Dict[str, Any] = {}
    _describe(state["params"], "params", leaves)
    if opt_state is not None:
        _describe(state["opt_state"], "opt_state", leaves)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(int(step)))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump({"format": FORMAT, "step": int(step), "leaves": leaves}, f, indent=1)
    if os.path.exists(final):  # a step saved again after a rollback
        stale = final + ".old.tmp"
        shutil.rmtree(stale, ignore_errors=True)
        os.replace(final, stale)
        shutil.rmtree(stale)
    os.replace(tmp, final)
    for old in snapshot_steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return sum(os.path.getsize(os.path.join(final, n)) for n in (STATE_FILE, META_FILE))


def _load(ckpt_dir: str, step: int) -> Dict[str, Any]:
    if step not in snapshot_steps(ckpt_dir):
        raise FileNotFoundError(f"no {FORMAT} snapshot of step {step} in {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(int(step)), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def restore(ckpt_dir: str, step: int, model, opt_state=None) -> None:
    """Load snapshot ``step`` into the live model's parameters and into
    ``opt_state``, in place: the parameters keep their identity (and the
    ``train_step`` closure its model), the state its lists and dicts."""
    from tpulab_torch.models.labformer import _flat

    state = _load(ckpt_dir, step)
    saved = state["params"]
    live = {*model.top.names, *(f"blocks/{n}" for n in model.blocks[0].names)}
    if set(saved) != live:
        raise ValueError(f"snapshot {step} holds leaves {sorted(saved)}; the model has "
                         f"{sorted(live)}")
    with torch.no_grad():
        for name in model.top.names:
            p = getattr(model.top, name)
            p.copy_(_take(saved[name], p, name))
        for name in model.blocks[0].names:
            stacked = saved[f"blocks/{name}"]
            for i, blk in enumerate(model.blocks):
                p = getattr(blk, name)
                p.copy_(_take(stacked[i], p, f"blocks/{name}"))
    if opt_state is not None:
        if "opt_state" not in state:
            raise ValueError(f"snapshot {step} in {ckpt_dir} holds no optimizer state")
        _decode_into(opt_state, state["opt_state"], param_keys(model), len(_flat(model)), "")


def read_params(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Snapshot ``step``'s parameter tree (CPU tensors, ``init_params``'
    nesting), without the optimizer state."""
    saved = _load(ckpt_dir, step)["params"]
    tree: Dict[str, Any] = {"blocks": {}}
    for key, t in saved.items():
        if key.startswith("blocks/"):
            tree["blocks"][key[7:]] = t
        else:
            tree[key] = t
    return tree


# ------------------------------------------------------------ the sidecar


def write_sidecar(ckpt_dir: str, cfg, tokenizer: Optional[str] = None) -> None:
    """``tpulab_config.json`` as ``tpulab``'s trainer writes it (the same
    keys and indentation), and the tokenizer copied in beside it."""
    from tpulab_torch.models.labformer import cfg_to_dict

    os.makedirs(ckpt_dir, exist_ok=True)
    sidecar = {"model": "labformer", "config": cfg_to_dict(cfg)}
    if tokenizer:
        dst = os.path.join(ckpt_dir, "tokenizer.json")
        if not (os.path.exists(dst) and os.path.samefile(tokenizer, dst)):
            shutil.copyfile(tokenizer, dst)
        sidecar["tokenizer"] = "tokenizer.json"
    with open(os.path.join(ckpt_dir, SIDECAR), "w") as f:
        json.dump(sidecar, f, indent=2)
