"""The scene, the tuning and the two-process worker of
``tests/test_torch_parallel.py``, in a module that imports the port only,
so that the worker processes it spawns start without jax."""

import dataclasses
import functools
import pickle

import numpy as np
import torch

from flydog_sdr_gps_tpu_torch import parallel as tpar
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.numerology import ADC_CLOCK_NOM
from flydog_sdr_gps_tpu_torch.ops import demod
from flydog_sdr_gps_tpu_torch.parallel import distributed as tdist

C, BLOCK, LMS_CH = 8, 128, 4
WARMUP, NBLOCKS = 8, 12        # the settled run starts at block WARMUP
MODES = [demod.MODE_USB, demod.MODE_LSB, demod.MODE_CW, demod.MODE_IQ,
         demod.MODE_USB, demod.MODE_LSB, demod.MODE_AM, demod.MODE_USB]
FREQS = [2.5e6 + 3.3e6 * i for i in range(C)]
# where each channel's tone sits against its frequency (in its passband)
OFFSETS = [700.0, -900.0, 500.0, 1300.0, 1100.0, -1500.0, 0.0, 2100.0]


@functools.lru_cache(maxsize=2)
def _scene(adc_block: int, nblocks: int, seed: int) -> np.ndarray:
    n = adc_block * nblocks
    t = np.arange(n, dtype=np.float64)
    x = 3e-3 * np.random.default_rng(seed).standard_normal(n)
    for i, (f, off) in enumerate(zip(FREQS, OFFSETS)):
        a = 0.02 + 0.01 * i
        x += a * np.cos(2 * np.pi * (((f + off) / ADC_CLOCK_NOM * t) % 1.0))
    x = x.astype(np.float32).reshape(nblocks, -1)
    return x


def scene(params, nblocks: int = NBLOCKS, seed: int = 5) -> np.ndarray:
    """A tone in every channel's passband, in noise: (nblocks, adc_block)
    float32, made once a process."""
    return _scene(params.ddc.adc_block, nblocks, seed)


def port_tunings(tp, lms: bool = False) -> trx.RxTuning:
    """The port's tuning of the scene's channels; ``lms`` switches the
    LMS chain on for LMS_CH."""
    t = trx.default_tuning(tp, "cpu", freqs_hz=FREQS, modes=MODES)
    if lms:
        t.nr_notch_on[LMS_CH] = True
        t.nr_den_on[LMS_CH] = True
    return trx.with_gates(t)


def run_two_process_worker(rank, init, out_path, blocks):
    """One process of a (2, 2) mesh whose time axis spans two gloo
    processes: runs ``blocks`` (its half of each) and pickles the whole-C
    taps and its DDC carries to ``out_path.<rank>``."""
    torch.set_num_threads(1)
    tdist.init_distributed(init, 2, rank, backend="gloo")
    mesh = tdist.make_global_mesh(time=2, chan=2, devices=["cpu"] * 2)
    assert mesh.local_rows == [rank] and mesh.num_processes == 2
    tp = trx.RxParams(num_channels=C, audio_block=BLOCK, stage2="unfused")
    step = tpar.make_sharded_rx_step(tp, mesh)
    st = tpar.shard_rx_state(trx.init_state(tp, "cpu"), mesh, tp)
    tts = tpar.shard_rx_tuning(port_tunings(tp, lms=True), mesh)
    half = tp.ddc.adc_block // 2
    out = []
    for x in blocks:
        st, sh_taps = step(st, tts, x[rank * half:(rank + 1) * half])
        taps = tpar.gather_taps(sh_taps, mesh, "cpu")
        out.append({f.name: getattr(taps, f.name).numpy()
                    for f in dataclasses.fields(taps)})
    out.append({"x_tail": st.ddc[0].x_tail.numpy(),
                "y_tail": torch.cat([d.y_tail for d in st.ddc], 1).numpy(),
                "phi1": torch.cat([d.phi1 for d in st.ddc]).numpy()})
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()
