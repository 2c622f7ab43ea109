"""A cell at a size the CPU holds: 16 channels, audio_block 128, a few
listeners of every wire format and mode, W/F sockets at z0 and z7."""

from __future__ import annotations

import copy
import os

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cell(traffic: str = "serve32_wf4", config: str = "kiwi12k_c4096",
              channels: int = 16, block: int = 128, listeners: int = 10,
              zooms=(0, 7)) -> harness.Cell:
    cfg = harness.load_json(os.path.join(HERE, "configs", config + ".json"))
    cfg = dict(cfg, channels=channels, audio_block=block, ring_blocks=3)
    cfg.pop("adc_block", None)
    mix = copy.deepcopy(harness.load_mix(traffic))
    groups, n = [], 0
    for g in mix["listeners"]:
        k = min(int(g.get("count", 1)), listeners - n)
        if k > 0:
            groups.append(dict(g, count=k))
            n += k
    mix["listeners"] = groups
    mix["waterfall"] = [w for w in mix.get("waterfall", [])
                        if w["zoom"] in zooms]
    mix["sample_blocks"] = 2
    return harness.Cell(name=f"{config}.{traffic}", cfg=cfg, mix=mix,
                        end_to_end=[], per_layer=[], chips=1)
