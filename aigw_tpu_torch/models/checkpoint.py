"""Checkpoint import, save and restore (counterpart of
``aigw_tpu/models/checkpoint.py``).

``import_hf_checkpoint`` reads local HuggingFace ``*.safetensors``
shards (Llama, Qwen2 and Mixtral layouts) into the port's flat
parameter dict with the standard library: the format is an 8-byte
little-endian header length, a JSON header naming each tensor's dtype,
shape and byte range, then the raw little-endian bytes, which
``torch.frombuffer`` reads from a copy-on-write ``mmap`` (bf16
included; no numpy bf16 type and no ``safetensors`` package). Tensors
move to the device one at a time, are cast there (round to nearest
even, as ``jnp.astype``) and transposed where ``_HF_MAP`` says: a
Llama-3-8B checkpoint (16 GB) is never held twice in host memory.

``save_checkpoint`` and ``restore_checkpoint`` read and write the
directory the reference's ``orbax.checkpoint.StandardCheckpointer``
writes for a flat dict, without orbax or jax: every array is a zarr v2
array (zstd) in one OCDBT database at the directory root, written and
read through ``tensorstore``, beside the JSON files orbax needs
(``_METADATA``, ``_sharding``, ``_CHECKPOINT_METADATA``). The reference
restores the port's directories and the port restores the reference's.
``tensorstore`` is imported only here, at the call; where it is missing
(the card machine has none) both raise ImportError naming it. Nothing
falls back to random weights.
"""

from __future__ import annotations

import base64
import json
import logging
import mmap
import os
import re
import struct
import time
from collections.abc import Iterator
from typing import Any, NamedTuple

import torch

logger = logging.getLogger(__name__)

#: safetensors dtype tag → torch dtype (both little-endian)
_ST_DTYPES: dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_ST_TAGS = {v: k for k, v in _ST_DTYPES.items()}

#: torch dtype → zarr v2 dtype string (what orbax writes)
_ZARR_DTYPES: dict[torch.dtype, str] = {
    torch.bfloat16: "bfloat16", torch.float16: "<f2",
    torch.float32: "<f4", torch.float64: "<f8", torch.int8: "|i1",
    torch.uint8: "|u1", torch.int32: "<i4", torch.int64: "<i8",
    torch.bool: "|b1",
}

#: HF tensor name → the port's flat name (the reference's map, in its
#: order). Projections are stored [out, in] in HF and transposed to the
#: [in, out] convention.
_HF_MAP = [
    (re.compile(r"^model\.embed_tokens\.weight$"), "embed", False),
    (re.compile(r"^model\.norm\.weight$"), "norm_f", False),
    (re.compile(r"^lm_head\.weight$"), "lm_head", True),
    (re.compile(r"^model\.layers\.(\d+)\.input_layernorm\.weight$"),
     "l{}.attn_norm", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.q_proj\.weight$"),
     "l{}.wq", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.k_proj\.weight$"),
     "l{}.wk", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.v_proj\.weight$"),
     "l{}.wv", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.o_proj\.weight$"),
     "l{}.wo", True),
    # Qwen2 QKV biases
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.q_proj\.bias$"),
     "l{}.bq", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.k_proj\.bias$"),
     "l{}.bk", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.v_proj\.bias$"),
     "l{}.bv", False),
    (re.compile(r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$"),
     "l{}.mlp_norm", False),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.gate_proj\.weight$"),
     "l{}.w_gate", True),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.up_proj\.weight$"),
     "l{}.w_up", True),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.down_proj\.weight$"),
     "l{}.w_down", True),
    # Mixtral MoE layout: experts are stacked into [E, ...] after loading
    (re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight$"),
     "l{}.gate", True),
    (re.compile(
        r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w1\.weight$"),
     "l{}.w_gate.__expert{}", True),
    (re.compile(
        r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w3\.weight$"),
     "l{}.w_up.__expert{}", True),
    (re.compile(
        r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w2\.weight$"),
     "l{}.w_down.__expert{}", True),
]


def _hf_target(name: str) -> tuple[str | None, bool]:
    for pattern, fmt, transpose in _HF_MAP:
        m = pattern.match(name)
        if m:
            return fmt.format(*m.groups()), transpose
    return None, False


# -- safetensors on the standard library ------------------------------------
def _read_header(f) -> tuple[dict[str, Any], int]:
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for each tensor of one ``.safetensors`` file,
    in sorted name order (as ``safe_open(...).keys()``). Each tensor is
    a host view of a copy-on-write map of the file, valid until the
    next one is yielded: copy or move it before asking for the next."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            for name in sorted(header):
                info = header[name]
                dtype = _ST_DTYPES.get(info["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: tensor {name!r} has dtype "
                                     f"{info['dtype']}, which is not read")
                begin, end = info["data_offsets"]
                shape = tuple(info["shape"])
                if end == begin:
                    yield name, torch.empty(shape, dtype=dtype)
                    continue
                t = torch.frombuffer(mm, dtype=dtype,
                                     count=(end - begin) // dtype.itemsize,
                                     offset=start + begin)
                yield name, t.view(shape)
                del t
        finally:
            try:
                mm.close()
            except BufferError:
                pass  # a caller still holds a view: closed with it


def save_safetensors(tensors: dict[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (any device) as one ``.safetensors`` file in
    name order, one tensor's host copy at a time; returns its bytes.
    The format's writer, for checkpoints made by tests and the card
    check (``safetensors.torch.save_file`` writes the same layout)."""
    header: dict[str, Any] = {}
    off = 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(tensors):
            host = tensors[name].detach().contiguous().cpu()
            if host.numel():
                f.write(memoryview(host.view(-1).view(torch.uint8).numpy()))
            del host
    return 8 + len(raw) + off


def import_hf_checkpoint(hf_dir: str, dtype: torch.dtype = torch.bfloat16,
                         device: str | torch.device = "cuda"
                         ) -> dict[str, torch.Tensor]:
    """Read local ``*.safetensors`` shards (sorted by file name) →
    flat params of ``dtype`` on ``device``: every mapped tensor cast
    (norms and biases too, as the reference), projections transposed,
    Mixtral's per-expert tensors stacked to ``[E, in, out]``. Unmapped
    names are ignored with a warning; a directory without shards raises
    FileNotFoundError."""
    from aigw_tpu_torch.device import resolve_device

    device = resolve_device(device)
    files = sorted(os.path.join(hf_dir, f) for f in os.listdir(hf_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {hf_dir}")
    params: dict[str, torch.Tensor] = {}
    unmapped: list[str] = []
    for path in files:
        for name, host in iter_safetensors(path):
            target, transpose = _hf_target(name)
            if target is None:
                unmapped.append(name)
                continue
            t = host.to(device, copy=True).to(dtype)
            if transpose:
                t = t.T.contiguous()
            params[target] = t
            del host, t
    if unmapped:
        logger.warning("unmapped HF tensors ignored: %s", unmapped[:8])
    return _stack_experts(params)


def _stack_experts(params: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """Collapse ``l{i}.w_*.__expert{E}`` staging keys into ``[E, ...]``
    tensors (Mixtral's per-expert HF tensors → the stacked MoE
    layout)."""
    staged: dict[str, dict[int, torch.Tensor]] = {}
    out: dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if ".__expert" in k:
            base, _, e = k.partition(".__expert")
            staged.setdefault(base, {})[int(e)] = v
        else:
            out[k] = v
    for base, experts in staged.items():
        out[base] = torch.stack([experts.pop(e) for e in sorted(experts)])
    return out


# -- orbax's directory through tensorstore ------------------------------------
def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "orbax checkpoints are read and written through the "
            "'tensorstore' package, which is not installed here "
            f"({e}); import HF safetensors with import_hf_checkpoint "
            "instead") from e
    return tensorstore


def _array_spec(path: str, key: str) -> dict[str, Any]:
    return {"driver": "zarr", "path": key,
            "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"}}


def save_checkpoint(params: dict[str, torch.Tensor], path: str) -> None:
    """Write ``params`` as the reference's ``save_checkpoint`` does: a
    flat dict in orbax's StandardCheckpointer layout (OCDBT, zarr v2,
    zstd level 1, one chunk an array). Tensors go to the host one at a
    time. Raises if ``path`` already holds a checkpoint."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, "_METADATA")):
        raise FileExistsError(f"a checkpoint already exists at {path}")
    os.makedirs(path, exist_ok=True)
    # aigw: lint-ok(determinism): orbax metadata stamp, no tensor reads it
    t0 = time.time_ns()
    ctx = ts.Context()
    tree: dict[str, Any] = {}
    sharding: dict[str, str] = {}
    for name in sorted(params):
        t = params[name]
        if t.dtype not in _ZARR_DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} is not saved")
        shape = list(t.shape)
        host = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            arr = host.view(torch.int16).numpy().view(
                ts.bfloat16.numpy_dtype)
        else:
            arr = host.numpy()
        spec = {**_array_spec(path, name), "metadata": {
            "shape": shape, "chunks": shape,
            "dtype": _ZARR_DTYPES[t.dtype], "fill_value": None,
            "compressor": {"id": "zstd", "level": 1}, "order": "C",
            "filters": None, "dimension_separator": "."}}
        store = ts.open(spec, create=True, context=ctx).result()
        store.write(arr).result()
        del host, arr, store
        tree[str((name,))] = {  # orbax's key of a flat dict's leaf
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": shape}}
        sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
            {"sharding_type": "SingleDeviceSharding",
             "device_str": "TFRT_CPU_0"})
    meta = {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(path, "_sharding"), "w") as f:
        json.dump(sharding, f, separators=(",", ":"))
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": t0,
            # aigw: lint-ok(determinism): orbax metadata stamp, no tensor
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}, f)
    logger.info("saved checkpoint to %s", path)


#: tensorstore dtype name → torch dtype
_TS_DTYPES: dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def restore_checkpoint(path: str,
                       like: dict[str, Any] | None = None,
                       device: str | torch.device = "cuda"
                       ) -> dict[str, torch.Tensor]:
    """A directory in orbax's StandardCheckpointer layout (the
    reference's or :func:`save_checkpoint`'s) → flat tensors on
    ``device``. ``like`` (name → anything with ``shape`` and ``dtype``,
    e.g. :func:`param_like`) names the tensors expected: a missing or
    extra name, or another shape or dtype, raises ValueError."""
    from aigw_tpu_torch.device import resolve_device

    ts = _tensorstore()
    device = resolve_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are "
                         "read")
    names = [e["key_metadata"][0]["key"]
             for e in meta["tree_metadata"].values()]
    if like is not None and set(names) != set(like):
        raise ValueError(
            f"{path}: tensors differ from the model's: missing "
            f"{sorted(set(like) - set(names))[:8]}, extra "
            f"{sorted(set(names) - set(like))[:8]}")
    ctx = ts.Context()
    out: dict[str, torch.Tensor] = {}
    for name in sorted(names):
        store = ts.open(_array_spec(path, name), open=True,
                        context=ctx).result()
        dtype = _TS_DTYPES.get(store.dtype.name)
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype "
                             f"{store.dtype.name}, which is not read")
        shape = tuple(store.shape)
        if like is not None:
            want = like[name]
            if tuple(want.shape) != shape or want.dtype != dtype:
                raise ValueError(
                    f"{path}: {name} is {dtype} {list(shape)}, the model "
                    f"wants {want.dtype} {list(want.shape)}")
        arr = store.read().result()
        if dtype == torch.bfloat16:
            host = torch.from_numpy(arr.view("<i2")).view(torch.bfloat16)
        else:
            host = torch.from_numpy(arr)
        out[name] = host.to(device)
        del arr, host, store
    return out


class Like(NamedTuple):
    """A tensor's shape and dtype (``restore_checkpoint``'s ``like``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def param_like(iter_params, cfg, dtype: torch.dtype) -> dict[str, Like]:
    """The model's tensors as ``name → (shape, dtype)`` records with
    ``.shape`` and ``.dtype``, from the family's ``iter_params`` traced
    on fake tensors (no memory, no draws): the port's
    ``jax.eval_shape(init_params)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return {name: Like(tuple(t.shape), t.dtype)
                for name, t in iter_params(0, cfg, dtype, "cpu")}
