"""List parsers (counterpart: latentaugment_tpu/utils/util_general.py:13-26)
and the port's device rules: compute runs on the card unless the caller
names the CPU, and no tensor changes device behind the caller's back."""

import numpy as np
import torch



def parse_comma_separated_list(s):
    """'a,b,c' -> ['a', 'b', 'c']."""
    if isinstance(s, (list, tuple)):
        return list(s)
    if s is None or s == "":
        return []
    return [x.strip() for x in str(s).split(",") if x.strip() != ""]


def parse_separated_list_comma(lst):
    """['a', 'b'] -> 'a,b'."""
    if isinstance(lst, str):
        return lst
    return ",".join(lst)


def resolve_device(name):
    """torch.device for `--device`; a CUDA device without CUDA raises
    instead of running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    return device


def same_device(a, b):
    """True if two torch.devices name one device ('cuda' is the current
    CUDA device)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def float_input(x, device, what="input"):
    """x as a float32 tensor on `device`. Host arrays are placed there; a
    tensor that lies on another device raises: nothing is copied between
    the card and the host silently."""
    if isinstance(x, torch.Tensor):
        if not same_device(x.device, device):
            raise ValueError(f"{what} lies on {x.device}, this object on {device}: "
                             "build it with device=... to match, or move the tensor")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)
