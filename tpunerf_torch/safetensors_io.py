"""A reader of the safetensors format, with the standard library and torch.

A `.safetensors` file is an 8-byte little-endian header length n, n bytes
of JSON — for each tensor its `dtype`, `shape` and `data_offsets` [begin,
end) into the data that follows, and an optional `__metadata__` map of
strings — then the raw little-endian bytes of the tensors.

`read_safetensors` maps the file (`mmap`, copy-on-write) and returns
tensors that view the mapping through `torch.frombuffer`: nothing is copied
on the host until a tensor is copied onward (to the card, or cast), so a
3.4 GB UNet file is read once. The mapping lives as long as a tensor of it
does.
"""
from __future__ import annotations

import json
import math
import mmap
import struct
from pathlib import Path
from typing import Dict, Union

import torch

# the format's dtype names that torch holds as they are
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a `.safetensors` file, in the file's dtypes, on
    the CPU. Raises ValueError on a dtype not in `DTYPES`, a header or
    tensor that runs past the file, or offsets that do not match a
    tensor's shape."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, no header length")
        f.seek(0)
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: a header of {n} bytes runs past the "
                             f"file's {size}")
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start, data = 8 + n, size - 8 - n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']!r}, "
                             f"not one of {sorted(DTYPES)}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= data:
            raise ValueError(f"{path}: {name}'s offsets [{begin}, {end}) "
                             f"run past the {data} bytes of data")
        if end - begin != count * itemsize:
            raise ValueError(f"{path}: {name}'s offsets hold {end - begin} "
                             f"bytes, its shape {shape} {count * itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + begin) % itemsize:
            # an unaligned tensor: its bytes copied into aligned storage
            raw = torch.frombuffer(mm, dtype=torch.uint8, offset=start + begin,
                                   count=end - begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, offset=start + begin,
                                         count=count).reshape(shape)
    return out
