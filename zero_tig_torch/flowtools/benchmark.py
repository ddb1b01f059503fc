"""Flow-model speed, size, FLOPs and memory benchmark.

Port of ``zero_tig_tpu/flowtools/benchmark.py`` (:30-220; reference
ptlflow_scripts/model_benchmark.py): per model, at the reference's 500x1000
operating point, the median of ``num_samples`` timed forwards after
``num_warmup`` discarded ones, the parameter count, the FLOPs and the
device's peak memory, written to CSV.

  * time: host clock around one forward that ends in
    ``torch.cuda.synchronize()`` (the sync inside the timed window);
  * ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the timed
    forwards, after a reset (absent on the CPU);
  * ``flops``: JAX reads XLA's ``cost_analysis()`` of the compiled forward.
    PyTorch has no twin of that, and ``FlopCounterMode`` cannot see inside
    a hand kernel's launch, so the FLOPs are counted on the plain path
    (the kernels' PyTorch twins) at the same shapes, on a CPU instance of
    the model with fake tensors (``FakeTensorMode``: shapes only, nothing
    computed): every ATen convolution and matrix product, counted as
    ``2 * MACs``. The number is not comparable to JAX's, which counts
    every operation XLA emits.
"""

from __future__ import annotations

import csv
import functools
import statistics
import time

import numpy as np
import torch

from ..core.device import resolve_device
from .registry import available_models, get_flow_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def count_flops(name: str, height: int, width: int, iters: int) -> float:
    """FLOPs of one forward of registry model ``name`` on (1, height, width,
    3) frames, counted on the plain path of a CPU instance with fake
    tensors; the count reads no weight, so it is made once per shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    fm = get_flow_model(name)
    cpu = fm.init_fn(0, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = torch.empty(1, height, width, 3)
        counter = FlopCounterMode(display=False)
        with counter:
            fm.forward_fn(cpu, a, a, iters, "highest")
    return float(counter.get_total_flops())


def count_params(model: torch.nn.Module) -> int:
    """Parameters and BatchNorm statistics, each tensor once: the leaves of
    the JAX variables tree ({'params', 'batch_stats'}) that JAX counts."""
    buffers = (b for name, b in model.named_buffers() if not name.endswith("num_batches_tracked"))
    return sum(t.numel() for t in model.parameters()) + sum(b.numel() for b in buffers)


def benchmark_model(
    name: str,
    *,
    height: int = 500,
    width: int = 1000,
    num_samples: int = 10,
    num_warmup: int = 2,
    iters: int | None = None,
    seed: int = 2,
    precision: str = "highest",
    device: str | torch.device | None = None,
) -> dict:
    """Benchmark one registered flow model at the reference operating point
    (500x1000 inputs, warm-up then median, model_benchmark.py:124-130,
    :316-335, :411-456) on ``device`` (the card unless the CPU is named)."""
    device = resolve_device(device)
    model_def = get_flow_model(name)
    iters = iters or model_def.default_iters
    gen = torch.Generator().manual_seed(seed)
    model = model_def.init_fn(gen, device=device)
    img1 = (torch.rand(1, height, width, 3, generator=gen) * 255).to(device)
    img2 = (torch.rand(1, height, width, 3, generator=gen) * 255).to(device)

    def run():
        out = model_def.forward_fn(model, img1, img2, iters, precision)
        _sync(device)
        return out

    for _ in range(num_warmup):
        run()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(num_samples):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    mem = {"peak_bytes": torch.cuda.max_memory_allocated(device)} if device.type == "cuda" else {}

    return {
        "model": name,
        "input_h": height,
        "input_w": width,
        "iters": iters,
        "precision": precision,
        "params": count_params(model),
        "flops": count_flops(name, height, width, iters),
        "time_ms_median": statistics.median(times) * 1e3,
        "time_ms_mean": float(np.mean(times)) * 1e3,
        **mem,
    }


def _write_csv(path: str, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=sorted(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def benchmark_all(csv_path: str | None = None, **kw) -> list[dict]:
    """Every registered model; a model that fails is reported and skipped,
    as the reference sidecar does."""
    rows = []
    for name in available_models():
        try:
            rows.append(benchmark_model(name, **kw))
        except Exception as e:  # per-model skip-on-failure, like the sidecar
            print(f"[benchmark] {name} failed: {e}")
    if csv_path and rows:
        _write_csv(csv_path, rows)
    return rows


def plot_benchmark(
    rows: list[dict],
    out_path: str,
    *,
    accuracy: dict[str, float] | None = None,
    html_path: str | None = None,
) -> str:
    """Speed-vs-accuracy scatter PNG from benchmark rows, and optionally an
    HTML page embedding it with the table (model_benchmark.py:459-530).
    Needs matplotlib, imported here: where it is absent this raises.

    accuracy: {model: EPE} from validate runs; without it the y axis is the
    parameter count."""
    import base64

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = [r["time_ms_median"] for r in rows]
    if accuracy:
        ys = [accuracy.get(r["model"], float("nan")) for r in rows]
        ylabel = "EPE (px)"
    else:
        ys = [r["params"] / 1e6 for r in rows]
        ylabel = "parameters (M)"

    fig, ax = plt.subplots(figsize=(6.4, 4.2), facecolor="#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    ax.scatter(xs, ys, s=60, color="#2a78d6", zorder=3)
    for r, x, y in zip(rows, xs, ys):
        ax.annotate(
            r["model"], (x, y), xytext=(6, 5), textcoords="offset points",
            fontsize=9, color="#52514e",
        )
    ax.set_xscale("log")
    ax.set_xlabel("inference time, median ms (log)", color="#0b0b0b")
    ax.set_ylabel(ylabel, color="#0b0b0b")
    ax.set_title(
        f"flow models @ {rows[0]['input_h']}x{rows[0]['input_w']}",
        color="#0b0b0b", fontsize=11,
    )
    ax.grid(True, color="#e6e5e1", linewidth=0.6, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#c3c2b7")
    fig.tight_layout()
    fig.savefig(out_path, dpi=144)
    plt.close(fig)

    if html_path:
        with open(out_path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        table = "".join(
            "<tr>" + "".join(f"<td>{r.get(k, '')}</td>" for k in sorted(rows[0])) + "</tr>"
            for r in rows
        )
        head = "".join(f"<th>{k}</th>" for k in sorted(rows[0]))
        with open(html_path, "w") as f:
            f.write(
                "<!doctype html><title>flow model benchmark</title>"
                "<body style='font-family:sans-serif;background:#fcfcfb'>"
                f"<img alt='speed vs accuracy scatter' "
                f"src='data:image/png;base64,{b64}'>"
                f"<table border=1 cellpadding=4 style='border-collapse:"
                f"collapse;color:#0b0b0b'><tr>{head}</tr>{table}</table>"
                "</body>"
            )
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("flow model benchmark")
    p.add_argument("--models", nargs="*", default=None)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--width", type=int, default=1000)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--precision", choices=("highest", "fast"), default="highest")
    p.add_argument("--output_csv", type=str, default="flow_benchmark.csv")
    p.add_argument(
        "--plot", type=str, default="",
        help="write a speed-vs-params scatter PNG here (plus .html twin); needs matplotlib",
    )
    args = p.parse_args(argv)
    names = args.models or available_models()
    rows = []
    for n in names:
        r = benchmark_model(
            n, height=args.height, width=args.width, num_samples=args.num_samples,
            precision=args.precision,
        )
        print(r)
        rows.append(r)
    _write_csv(args.output_csv, rows)
    if args.plot:
        html = (
            args.plot.rsplit(".", 1)[0] + ".html"
            if args.plot.endswith(".png") else args.plot + ".html"
        )
        plot_benchmark(rows, args.plot, html_path=html)
    return rows


if __name__ == "__main__":
    main()
