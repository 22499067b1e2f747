"""What the benchmark takes from the program (meterelf_tpu_torch): the
system under test built from a configuration file, and a decoder that
keeps what the timed path produced for the comparison. Imported only
after the frame pool has started, since it imports torch."""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from . import gen


def params_dict(cfg: Dict, template_file: str) -> Dict:
    """The upstream params.yml schema (meterelf/_params.py) of a
    configuration."""
    return {
        "image_glob": "*.jpg",
        "meter_rect": cfg["meter_rect"],
        "dials_template": template_file,
        "dials_template_match_threshold":
            cfg["dials_template_match_threshold"],
        "dials_template_size": [cfg["template"]["width"],
                                cfg["template"]["height"]],
        "hue_shift": cfg["hue_shift"],
        "needle_color": cfg["needle_color"],
        "needle_color_range": cfg["needle_color_range"],
        "needle_data": cfg["dials"],
    }


def params(cfg: Dict) -> Any:
    """The program's Params of a configuration, the template given as an
    array."""
    from meterelf_tpu_torch.params import Params

    return Params("", params_dict(cfg, "template.png"),
                  template=gen.make_template(cfg))


def _yaml(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return '"' + value + '"'
    if isinstance(value, list):
        return "[" + ", ".join(_yaml(v) for v in value) + "]"
    return "{" + ", ".join(f"{k}: {_yaml(v)}" for k, v in value.items()) + "}"


def write_params(cfg: Dict, directory: str) -> str:
    """Write the configuration as a parameters directory (params.yml and
    the template as an 8-bit grey PNG beside it) for the file API;
    returns the yml's path."""
    t = gen.make_template(cfg)
    raw = b"".join(b"\x00" + row.tobytes() for row in t)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", t.shape[1], t.shape[0],
                                        8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(os.path.join(directory, "template.png"), "wb") as fp:
        fp.write(png)
    path = os.path.join(directory, "params.yml")
    with open(path, "w") as fp:
        for key, value in params_dict(cfg, "template.png").items():
            if key == "needle_data":
                fp.write("needle_data:\n")
                fp.writelines(f"  - {_yaml(d)}\n" for d in value)
            else:
                fp.write(f"{key}: {_yaml(value)}\n")
    return path


def keeping_decoder(prm: Any, device: str, keep: str) -> Any:
    """A MeterDecoder that keeps, while ``keeping`` is set, either the
    device result of every default-caps ``decode`` (keep="decode": the
    stream's and the coefficient step's call) or a host copy of every
    ``decode_numpy`` result (keep="numpy": the file API's call)."""
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    class Keeping(MeterDecoder):
        def __init__(self) -> None:
            super().__init__(prm, device=device)
            self.keeping = False
            self.kept: List[Any] = []

        def decode(self, crops: Any, load_ok: Any = None,
                   caps: Optional[Any] = None) -> Any:
            res = super().decode(crops, load_ok, caps)
            if self.keeping and keep == "decode" and caps is None:
                self.kept.append(res)
            return res

        def decode_numpy(self, crops: Any, load_ok: Any = None) -> Any:
            res = super().decode_numpy(crops, load_ok)
            if self.keeping and keep == "numpy":
                # a pageable copy: the pinned buffers go back to the cache
                self.kept.append(type(res)(*[np.array(v) for v in res]))
            return res

    return Keeping()
