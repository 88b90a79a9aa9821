"""`scripts/trace_edges.py`'s readers on a hand-made Chrome trace: the
device records of each graph replay, by name and in launch order, and how
far the last of them lies after the synchronisation that waited for it."""
import json

from tpunerf_torch.scripts.trace_edges import ahead_us, replay_records


def _event(cat, name, ts, corr, dur=1.0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace(tmp_path):
    events = [
        # launched second, listed first: order comes from the launch times
        _event("cuda_runtime", "cudaGraphLaunch", 20.0, 7),
        _event("cuda_runtime", "cudaGraphLaunch", 10.0, 3),
        _event("cuda_runtime", "cudaLaunchKernel", 30.0, 9),
        _event("cuda_runtime", "cudaDeviceSynchronize", 5.0, 1, dur=2.0),
        _event("cuda_runtime", "cudaDeviceSynchronize", 31.0, 10, dur=9.0),
        _event("cuda_runtime", "cudaDeviceSynchronize", 45.0, 11),
        _event("kernel", "hashgrid_fwd_kernel<2>", 11.0, 3),
        _event("kernel", "hashgrid_bwd_kernel<2>", 12.0, 3),
        _event("gpu_memset", "Memset (Device)", 13.0, 3),
        _event("kernel", "hashgrid_fwd_kernel<2>", 21.0, 7),
        _event("gpu_memset", "Memset (Unknown)", 22.0, 7),
        _event("kernel", "eager_kernel", 41.0, 9, dur=1.5),  # no replay's
        _event("ac2g", "ac2g", 11.0, 3),                    # a flow
        {"ph": "M", "name": "process_name", "args": {"name": "python3"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_replay_records_counts_each_replays_device_records(tmp_path):
    first, second = replay_records(_trace(tmp_path))
    assert first == {"hashgrid_fwd_kernel<2>": 1, "hashgrid_bwd_kernel<2>": 1,
                     "Memset": 1}
    assert second == {"hashgrid_fwd_kernel<2>": 1, "Memset": 1}
    assert dict(first - second) == {"hashgrid_bwd_kernel<2>": 1}


def test_ahead_us_measures_from_the_first_sync_after_the_last_launch(
        tmp_path):
    # the last record ends at 42.5; the sync that began at 31 ended at 40
    assert ahead_us(_trace(tmp_path)) == 2.5
