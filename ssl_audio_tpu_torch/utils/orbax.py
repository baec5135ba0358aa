"""Reading the JAX package's Orbax checkpoints without JAX (the reading half
of ssl_audio_tpu/utils/checkpoint.py: load_checkpoint, load_params_only and
the raw PyTreeCheckpointer().restore of load_encoder_checkpoint).

An Orbax checkpoint directory holds `_METADATA`, a JSON file whose
"tree_metadata" names every leaf of the saved tree by its key path (each
key a dict key or a sequence index) with its kind ("np.ndarray",
"jax.Array", "scalar"; "None" and empty containers are not stored), and
the leaves themselves: one zarr array per leaf, named by the dotted key
path, in an OCDBT key-value store where "use_ocdbt" is true (what
`ocp.StandardCheckpointer` writes), else in a directory of that name, zarr
v2 unless "use_zarr3" is true.  tensorstore reads every one of these
layouts; it comes with orbax-checkpoint, and is imported only inside
read_orbax_tree, so this module imports where it is absent (the card's
machine has neither): there, convert the checkpoint first, where it was
written, with

    python -m ssl_audio_tpu_torch.tools.convert_checkpoint --ckpt DIR --to pt ...

read_orbax_tree returns the tree as JAX's raw restore does: nested dicts,
lists for sequences, numpy arrays, Python scalars for scalar leaves, None
and empty containers where they were saved; a bfloat16 leaf comes back as
a torch.bfloat16 tensor (numpy has no bfloat16), through a uint16 view.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

METADATA = "_METADATA"
CONVERT_HINT = ("convert it where it was written (orbax-checkpoint, and with it "
                "tensorstore, is installed there): python -m "
                "ssl_audio_tpu_torch.tools.convert_checkpoint --ckpt DIR --to pt --out "
                "model_K.pt [the run's flags]")

# orbax's KeyType: the kind of each key of a leaf's path
_SEQUENCE, _DICT = 1, 2
_ARRAY_KINDS = ("np.ndarray", "jax.Array", "scalar")
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": list}


def is_orbax_dir(path: str) -> bool:
    """True for a directory that holds Orbax's `_METADATA`."""
    return bool(path) and os.path.isfile(os.path.join(path, METADATA))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(f"reading an Orbax checkpoint needs the tensorstore package, "
                          f"which is not installed here; {CONVERT_HINT}") from e
    return tensorstore


def _metadata(path: str) -> dict:
    if not os.path.isdir(path):
        raise ValueError(f"{path}: not an Orbax checkpoint directory (it is "
                         f"{'a file' if os.path.exists(path) else 'missing'})")
    if not os.path.isfile(os.path.join(path, METADATA)):
        raise ValueError(f"{path}: not an Orbax checkpoint directory: no {METADATA} among "
                         f"{sorted(os.listdir(path))[:12]}")
    with open(os.path.join(path, METADATA)) as f:
        try:
            md = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}/{METADATA} is not JSON: {e}") from e
    if not isinstance(md, dict) or not isinstance(md.get("tree_metadata"), dict):
        raise ValueError(f"{path}/{METADATA}: no 'tree_metadata' (keys "
                         f"{sorted(md) if isinstance(md, dict) else type(md).__name__})")
    return md


def _keys(path: str, name: str, entry: dict) -> list:
    """The leaf's key path: [(key, is_sequence_index), ...]."""
    kms = entry.get("key_metadata")
    if not kms:
        raise ValueError(f"{path}: leaf {name} has no key_metadata")
    out = []
    for km in kms:
        if km.get("key_type") not in (_SEQUENCE, _DICT):
            raise ValueError(f"{path}: leaf {name}: key type {km.get('key_type')!r} "
                             f"is neither a dict key nor a sequence index")
        out.append((str(km["key"]), km["key_type"] == _SEQUENCE))
    return out


def _spec(root: str, leaf: str, md: dict) -> dict:
    driver = "zarr3" if md.get("use_zarr3") else "zarr"
    if md.get("use_ocdbt"):
        kv = {"driver": "ocdbt", "base": f"file://{root}/", "path": leaf}
    else:
        kv = {"driver": "file", "path": os.path.join(root, leaf) + "/"}
    return {"driver": driver, "kvstore": kv}


def _as_value(a: np.ndarray, kind: str):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    if kind == "scalar":
        return a.item()
    return np.asarray(a)


def _nest(path: str, items: list) -> dict:
    """[(key path, value)] -> nested dicts, a sequence's indices into a list."""
    root: dict = {}
    seq: set = set()
    for keys, value in items:
        node, where = root, ()
        for i, (k, is_seq) in enumerate(keys):
            if is_seq:
                seq.add(where)
            where = where + (k,)
            if i == len(keys) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})
                if not isinstance(node, dict):
                    raise ValueError(f"{path}: leaf {'/'.join(where)} is also a container")

    def lists(node, where=()):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v, where + (k,)) for k, v in node.items()}
        if where in seq:
            idx = sorted(out, key=int)
            if [int(i) for i in idx] != list(range(len(idx))):
                raise ValueError(f"{path}: sequence {'/'.join(where)} has indices {idx}")
            return [out[i] for i in idx]
        return out

    return lists(root)


def read_orbax_tree(path: str) -> dict:
    """The tree saved at `path` (see the module docstring).  ValueError
    for a directory that is not an Orbax checkpoint or a leaf of a kind this
    reader does not map; ImportError (with the converter's command) where
    tensorstore is absent."""
    path = os.path.abspath(path)
    md = _metadata(path)
    ts = _tensorstore()
    items, pending = [], []
    ctx = ts.Context()
    for name, entry in md["tree_metadata"].items():
        keys = _keys(path, name, entry)
        kind = (entry.get("value_metadata") or {}).get("value_type")
        if kind in _EMPTY:
            empty = _EMPTY[kind]
            items.append((keys, None if empty is None else empty()))
        elif kind in _ARRAY_KINDS:
            leaf = ".".join(k for k, _ in keys)
            pending.append((keys, kind, leaf, ts.open(_spec(path, leaf, md), open=True,
                                                      context=ctx)))
        else:
            raise ValueError(f"{path}: leaf {'/'.join(k for k, _ in keys)} is a {kind!r}, "
                             f"which this reader does not map (arrays, scalars, None and "
                             f"empty containers only)")
    reads = []
    for keys, kind, leaf, fut in pending:
        try:
            reads.append((keys, kind, fut.result().read()))
        except Exception as e:
            raise ValueError(f"{path}: cannot open leaf {leaf}: {e}") from e
    for keys, kind, fut in reads:
        items.append((keys, _as_value(fut.result(), kind)))
    return _nest(path, items)
