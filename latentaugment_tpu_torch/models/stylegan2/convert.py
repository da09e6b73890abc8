"""Ingest NVIDIA StyleGAN2 / StyleGAN3 network pickles and TF-era pickles
without executing what they embed (counterpart:
latentaugment_tpu/models/stylegan2/convert.py:33-424; its orbax and
`save_checkpoint` halves are the JAX package's own, and native files are
written by checkpoint.py).

NVIDIA's `torch_utils.persistence` stores every network as module source
plus state and rebuilds it by running that source. Here a restricted
unpickler instead:

  * resolves only an exact-name allow-list of the callables a tensor,
    ndarray or state-dict pickle needs (no `builtins.*` beyond set /
    frozenset, no wildcard torch); anything else raises
    `pickle.UnpicklingError`;
  * intercepts `torch_utils.persistence._reconstruct_persistent_obj` and
    returns its payload (class name, init kwargs, module state) as an
    inert `_PersistencePayload`, every other `torch_utils.*` name likewise,
    and turns `dnnlib.*` into `EasyDict` (the TF `Network` into
    legacy.TFNetworkStub, an EasyDict that keeps its state);
  * sends a nested `torch.storage._load_from_bytes` stream to
    `torch.load(..., weights_only=True)`.

The payload's flat state dict is then mapped onto nested numpy trees
whose joined paths are the port modules' `state_dict` keys, what
`checkpoint.params_to_state_dict` takes. The per-layer 2-D resample
filters collapse to one 1-D filter (`separable_factor`): kernel K2's
separable variants take only 1-D taps.
"""

import functools
import io
import pickle

import numpy as np
import torch

from ...ops.upfirdn2d import separable_factor, setup_filter
from ...utils.util_easydict import EasyDict
from . import checkpoint, networks


class _PersistencePayload(EasyDict):
    """Marker for an intercepted persistence-pickled torch module."""


def _reconstruct_stub(meta):
    return _PersistencePayload(meta)


def _safe_load_from_bytes(b):
    """torch.storage._load_from_bytes with weights_only forced on, so the
    nested stream cannot smuggle arbitrary reduce calls."""
    return torch.load(io.BytesIO(b), weights_only=True)


@functools.lru_cache(maxsize=1)
def _allowed_globals():
    """Exact-name allow-list of reconstruction callables: only what a
    tensor / ndarray / state-dict pickle needs. find_class('builtins',
    'eval') must fail."""
    import codecs
    import collections
    import importlib
    import warnings

    table = {
        ("collections", "OrderedDict"): collections.OrderedDict,
        ("_codecs", "encode"): codecs.encode,
        # Protocol-2 pickles of set / frozenset name them (the py2-era
        # '__builtin__' too). Plain constructors only.
        ("builtins", "set"): set,
        ("builtins", "frozenset"): frozenset,
        ("__builtin__", "set"): set,
        ("__builtin__", "frozenset"): frozenset,
        ("numpy", "ndarray"): np.ndarray,
        ("numpy", "dtype"): np.dtype,
    }
    # Old pickles name numpy.core.*, numpy 2 names numpy._core.*; both must
    # resolve, and touching the old path on numpy 2 warns on every import.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=DeprecationWarning,
                                message=".*numpy[._]core.*")
        for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
            try:
                m = importlib.import_module(mod)
            except ImportError:
                continue
            table[(mod, "_reconstruct")] = m._reconstruct
            table[(mod, "scalar")] = m.scalar
        for mod in ("numpy.core.numeric", "numpy._core.numeric"):
            try:
                table[(mod, "_frombuffer")] = importlib.import_module(mod)._frombuffer
            except (ImportError, AttributeError):
                pass
    table[("torch._utils", "_rebuild_tensor")] = torch._utils._rebuild_tensor
    table[("torch._utils", "_rebuild_tensor_v2")] = torch._utils._rebuild_tensor_v2
    table[("torch._utils", "_rebuild_parameter")] = torch._utils._rebuild_parameter
    table[("torch.storage", "_load_from_bytes")] = _safe_load_from_bytes
    table[("torch", "Size")] = torch.Size
    table[("torch", "device")] = torch.device
    for st in ("FloatStorage", "HalfStorage", "DoubleStorage", "IntStorage",
               "LongStorage", "ShortStorage", "CharStorage", "ByteStorage",
               "BoolStorage", "BFloat16Storage", "UntypedStorage"):
        if hasattr(torch, st):
            table[("torch", st)] = getattr(torch, st)
    return table


class _RestrictedUnpickler(pickle.Unpickler):
    """Allow tensor / state reconstruction; refuse everything else."""

    def find_class(self, module, name):
        if module == "torch_utils.persistence" and name == "_reconstruct_persistent_obj":
            return _reconstruct_stub
        if module.startswith("torch_utils."):
            # Persistence metadata (EasyDict in meta dicts): inert stand-ins,
            # never torch_utils' code.
            return EasyDict if name == "EasyDict" else _reconstruct_stub
        if module == "dnnlib.tflib.network" and name == "Network":
            from .legacy import TFNetworkStub

            return TFNetworkStub
        if module == "dnnlib" or module.startswith("dnnlib."):
            return EasyDict
        fn = _allowed_globals().get((module, name))
        if fn is None:
            raise pickle.UnpicklingError(
                f"Blocked unpickle of {module}.{name}: not in the exact-name "
                "allow-list of tensor-reconstruction callables")
        return fn


def load_network_pickle(path_or_file):
    """An NVIDIA-format pickle -> dict of _PersistencePayload / tensors."""
    return _RestrictedUnpickler(io.BytesIO(checkpoint.read_bytes(path_or_file))).load()


def _tensor_to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _module_dict(obj):
    """The module __dict__ of a payload or plain module state. In NVIDIA
    pickles every layer class is persistent, so submodules arrive as
    nested payloads whose module dict lives under ['state']."""
    if isinstance(obj, _PersistencePayload):
        st = obj.get("state", obj)
        return st if isinstance(st, dict) else getattr(st, "__dict__", {})
    if isinstance(obj, dict):
        return obj
    return getattr(obj, "__dict__", {})


def payload_state_dict(payload):
    """Flat {name: np.ndarray} of a persistence payload's module state (an
    nn.Module __dict__ with _parameters / _buffers / _modules nesting), or
    of a plain nested state dict."""
    state = payload.get("state", payload)
    flat = {}

    def visit(prefix, obj):
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            flat[prefix] = _tensor_to_np(obj)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                if isinstance(k, str):
                    visit(f"{prefix}.{k}" if prefix else k, v)

    def visit_module(prefix, d):
        for bucket in ("_parameters", "_buffers"):
            for k, v in (d.get(bucket) or {}).items():
                if v is not None:
                    flat[f"{prefix}.{k}" if prefix else k] = _tensor_to_np(v)
        for k, sub in (d.get("_modules") or {}).items():
            if sub is not None:
                visit_module(f"{prefix}.{k}" if prefix else k, _module_dict(sub))

    state_d = _module_dict(state) if isinstance(state, _PersistencePayload) else state
    if isinstance(state_d, dict) and "_modules" in state_d:
        visit_module("", state_d)
    else:
        visit("", state)
    return flat


def _payload_init_kwargs(payload):
    """Init kwargs of a payload: the instance attributes (z_dim, ...) from
    its state, then the `_init_kwargs` persistence records there, then a
    top-level 'init_kwargs' (simplified payloads)."""
    kwargs = EasyDict()
    state = payload.get("state") if isinstance(payload, dict) else None
    if isinstance(state, dict):
        for key in ("z_dim", "c_dim", "w_dim", "img_resolution", "img_channels"):
            if key in state:
                kwargs[key] = state[key]
        ik = state.get("_init_kwargs")
        if isinstance(ik, dict):
            kwargs.update(ik)
    if "init_kwargs" in payload:
        kwargs.update(payload["init_kwargs"])
    return kwargs


def infer_generator_config(payload, img_resolution=None, img_channels=None):
    """generator_config from the persistence init kwargs (or overrides);
    bf16 blocks are a run-time choice, so num_fp16_res is 0."""
    kwargs = _payload_init_kwargs(payload)
    syn = kwargs.get("synthesis_kwargs", {}) or {}
    mapping = kwargs.get("mapping_kwargs", {}) or {}
    return networks.generator_config(
        z_dim=kwargs.get("z_dim", 512), c_dim=kwargs.get("c_dim", 0),
        w_dim=kwargs.get("w_dim", 512),
        img_resolution=img_resolution or kwargs.get("img_resolution", 256),
        img_channels=img_channels or kwargs.get("img_channels", 2),
        channel_base=syn.get("channel_base", 32768), channel_max=syn.get("channel_max", 512),
        num_mapping_layers=mapping.get("num_layers", 8),
        embed_features=mapping.get("embed_features"),
        conv_clamp=syn.get("conv_clamp", 256), num_fp16_res=0)


def infer_discriminator_config(payload, img_resolution=None, img_channels=None):
    kwargs = _payload_init_kwargs(payload)
    block = kwargs.get("block_kwargs", {}) or {}
    epilogue = kwargs.get("epilogue_kwargs", {}) or {}
    mapping = kwargs.get("mapping_kwargs", {}) or {}
    return networks.discriminator_config(
        c_dim=kwargs.get("c_dim", 0),
        cmap_dim=epilogue.get("cmap_dim", kwargs.get("cmap_dim")),
        num_mapping_layers=mapping.get("num_layers", 8),
        img_resolution=img_resolution or kwargs.get("img_resolution", 256),
        img_channels=img_channels or kwargs.get("img_channels", 2),
        channel_base=kwargs.get("channel_base", 32768),
        channel_max=kwargs.get("channel_max", 512),
        conv_clamp=block.get("conv_clamp", kwargs.get("conv_clamp", 256)),
        mbstd_group_size=epilogue.get("mbstd_group_size",
                                      kwargs.get("mbstd_group_size", 4)) or 4,
        mbstd_num_channels=epilogue.get("mbstd_num_channels",
                                        kwargs.get("mbstd_num_channels", 1)))


def _separable_or_2d(value):
    """A stored resample filter factored to 1-D taps where it is rank-1
    and symmetric (kernel K2's separable variants), else kept 2-D."""
    arr = np.asarray(value, dtype=np.float32)
    fac = separable_factor(arr)
    return fac if fac is not None else arr


def _default_resample_filter():
    return setup_filter([1, 3, 3, 1], separable=True).numpy()


# ----------------------------------------------------------------------------
# State dict -> nested numpy tree

def _set_path(tree, path, value):
    *parents, leaf = path.split(".")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = np.asarray(value, dtype=np.float32)


def generator_tree_from_state(state, cfg):
    """Torch G state-dict names (mapping.fc{i}.*, mapping.w_avg,
    synthesis.b{res}.{const,conv0,conv1,torgb}.*, the per-block and
    per-layer resample_filter buffers) onto the port's nested tree, with
    one synthesis.resample_filter."""
    del cfg  # the names carry the layout
    tree = {"mapping": {}, "synthesis": {}}
    resample_filter = None
    for name, value in state.items():
        if name.endswith("resample_filter"):
            resample_filter = _separable_or_2d(value)
        elif name.startswith("mapping."):
            _set_path(tree["mapping"], name[len("mapping."):], value)
        elif name.startswith("synthesis."):
            _set_path(tree["synthesis"], name[len("synthesis."):], value)
        else:
            _set_path(tree, name, value)
    tree["synthesis"]["resample_filter"] = (resample_filter if resample_filter is not None
                                            else _default_resample_filter())
    _strip_noise_strength_scalars(tree["synthesis"])
    return tree


def _strip_noise_strength_scalars(syn_tree):
    """noise_strength arrives as [1] or []: the modules hold a scalar."""
    for block in syn_tree.values():
        if not isinstance(block, dict):
            continue
        for conv in ("conv0", "conv1"):
            layer = block.get(conv)
            if isinstance(layer, dict) and "noise_strength" in layer:
                layer["noise_strength"] = np.asarray(layer["noise_strength"],
                                                     np.float32).reshape(())


def discriminator_tree_from_state(state, cfg):
    del cfg
    tree = {}
    resample_filter = None
    for name, value in state.items():
        if name.endswith("resample_filter"):
            resample_filter = _separable_or_2d(value)
        else:
            _set_path(tree, name, value)
    tree["resample_filter"] = (resample_filter if resample_filter is not None
                               else _default_resample_filter())
    return tree


def load_stylegan(path, img_resolution=None, img_channels=None):
    """Any supported pickle -> (G_params, G_cfg, D_params, D_cfg), params as
    nested numpy trees (D_* None when the file holds no D).

    Dispatch: a native checkpoint (checkpoint.py's layout); a TF-era pickle
    ((G, D, Gs) or a dict of TF networks: legacy.py); an NVIDIA persistence
    pickle ({'G_ema' or 'G': ..., 'D': ...}), whose generator is alias-free
    when its class name says 'stylegan3' (stylegan3/convert.py; its D is
    the StyleGAN2 one). `img_resolution` / `img_channels` override what an
    NVIDIA payload records."""
    obj = load_network_pickle(path)
    # checkpoint.load_stylegan reads native files numpy-only and never
    # sends one here; this branch serves direct callers, as in the JAX API.
    if checkpoint.is_native(obj):
        return checkpoint.from_native(obj)

    from .legacy import TFNetworkStub, convert_tf_networks

    nets = obj if isinstance(obj, dict) else {}
    if isinstance(obj, tuple) or any(isinstance(v, TFNetworkStub) for v in nets.values()):
        nets = convert_tf_networks(obj)
        g_params, g_cfg = next(nets[k] for k in ("G_ema", "Gs", "G") if k in nets)
        d_params, d_cfg = nets.get("D", (None, None))
        return g_params, g_cfg, d_params, d_cfg

    g_payload = nets.get("G_ema", nets.get("G"))
    if not isinstance(g_payload, dict):
        raise ValueError("neither a native checkpoint nor a network pickle: no G_ema / G "
                         f"network in a {type(obj).__name__}")
    d_payload = nets.get("D")
    if "stylegan3" in str(g_payload.get("class_name", "")):
        from ..stylegan3 import convert as convert_sg3

        g_cfg = convert_sg3.infer_generator_config(g_payload, img_resolution, img_channels)
        g_params = convert_sg3.generator_tree_from_state(payload_state_dict(g_payload), g_cfg)
    else:
        g_cfg = infer_generator_config(g_payload, img_resolution, img_channels)
        g_params = generator_tree_from_state(payload_state_dict(g_payload), g_cfg)
    d_params = d_cfg = None
    if d_payload is not None:
        d_cfg = infer_discriminator_config(d_payload, img_resolution, img_channels)
        d_params = discriminator_tree_from_state(payload_state_dict(d_payload), d_cfg)
    return g_params, g_cfg, d_params, d_cfg
