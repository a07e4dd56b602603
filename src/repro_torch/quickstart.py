"""Quickstart — the paper's own example, end to end, on the card.

Part 1 builds the Mandelbrot application from a textual ``.cgpp``
specification (Listing 2 of the paper), verifies the deployment formally
(section 7), prints the generated deployment plan (section 4 / figure 1),
runs it on the chosen backend and reports the paper's counts + per-node
timing (requirement 7).  Every work item renders and sums one line in one
launch of the CUDA escape-time kernel: in a worker thread of this process
on the ``threads`` backend, in a worker of a node-loader subprocess on the
``cluster`` backend (paper section 4: the host ships the work function over
TCP and every node opens its own CUDA context).

Part 2 builds the same workload as a *two-stage pipeline* with the fluent
Python API — Mandelbrot lines rendered by stage 1, reduced per line by
stage 2 — and runs it on the same backend: the generalised spec layer with
the paper's network as its one-stage special case.

Run:  PYTHONPATH=src python -m repro_torch.quickstart
      PYTHONPATH=src python -m repro_torch.quickstart cluster  # subprocesses
      PYTHONPATH=src python -m repro_torch.quickstart --device cpu \\
          --width 300 --lines 32 --iters 100      # plain PyTorch, no card

The default instance is the paper's: 3,200 lines of 5,600 points, escape
value 1,000, on 2 clusters of 4 cores.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec, Pipeline, PipelineSpec, parse_cgpp
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.core.verify import verify_spec
from repro_torch.device import resolve_device
from repro_torch.kernels.mandelbrot import kernel as mandelbrot_kernel
from repro_torch.kernels.mandelbrot.ops import mandelbrot_line_stats

WIDTH = 5600
LINES = 3200
MAX_ITERATIONS = 1000
# What a node-loader imports while it registers, so the import of torch and
# of the work function's module lands in its boot time, not its load time.
NODE_PRELOAD = ("repro_torch.quickstart",)

SPEC = """
# Mandelbrot DSL specification (paper Listing 2), python-flavoured .cgpp
cores = 4
clusters = 2
max_iterations = %(iters)d
width = %(width)d

//@emit 192.168.1.176
emit_details = DataDetails(
    name="Mdata",
    init=lambda width, iters: (0, %(lines)d),
    init_data=(width, max_iterations),
    create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
)
emit = Emit(e_details=emit_details)
onrl = OneNodeRequestedList()

//@cluster clusters
nrfa = NodeRequestingFanAny(destinations=cores)
group = AnyGroupAny(workers=cores, function=CALCULATE)
afoc = AnyFanOne(sources=cores)

//@collect
result_details = ResultDetails(
    name="Mcollect",
    init=lambda: dict(points=0, white=0, black=0, total_iters=0),
    collect=COLLECTOR,
    finalise=lambda acc: acc,
)
afo = AnyFanOne(sources=clusters)
collector = Collect(r_details=result_details)
"""


@dataclass(frozen=True)
class Calculate:
    """The user's sequential data method (paper Mdata.calculateColour).

    A module-level class, so that plain ``pickle`` ships it to a node-loader
    by reference (the node imports it from ``repro_torch.quickstart``) and
    the job runs the same whether cloudpickle is installed or not.  The
    device travels by name and is resolved where the work runs; the result
    is plain ints, never a tensor.
    """

    width: int
    max_iters: int
    device: str

    def __call__(self, line_y: int) -> dict:
        white, total_iters = mandelbrot_line_stats(
            self.width, line_y, self.max_iters, device=self.device).tolist()
        return {"points": self.width, "white": white,
                "total_iters": total_iters}


def make_calculate(width: int, max_iters: int, device=None) -> Calculate:
    """The work function on ``device`` (default: the card).

    On a CUDA device the line kernel's library is built here, in the host
    process, before any node-loader starts: the nodes then load it by the
    hash of its source instead of each running ``nvcc``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        mandelbrot_kernel.load()
    return Calculate(width, max_iters, str(dev))


def collector(acc, item):
    acc["points"] += item["points"]
    acc["white"] += item["white"]
    acc["black"] += item["points"] - item["white"]
    acc["total_iters"] += item["total_iters"]
    return acc


def reduce_line(item):
    """Stage-2 work: collapse one line's stats into a compact record."""
    return (item["points"], item["white"], item["total_iters"])


def mandelbrot_spec(width: int = WIDTH, lines: int = LINES,
                    max_iters: int = MAX_ITERATIONS, *,
                    device=None) -> ClusterSpec:
    """The paper's job as a parsed ``.cgpp`` spec; work runs on ``device``."""
    calculate = make_calculate(width, max_iters, device)
    return parse_cgpp(
        SPEC % {"iters": max_iters, "width": width, "lines": lines},
        namespace={"CALCULATE": calculate, "COLLECTOR": collector},
    )


def fluent_spec(width: int = WIDTH, lines: int = LINES // 4,
                max_iters: int = MAX_ITERATIONS, *,
                device=None) -> PipelineSpec:
    """The same workload as a two-stage pipeline via the fluent API."""
    emit = EmitDetails(
        name="Mdata",
        init=lambda n: (0, n),
        init_data=(lines,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
    )

    def fold(acc, item):
        points, white, iters = item
        acc["points"] += points
        acc["white"] += white
        acc["black"] += points - white
        acc["total_iters"] += iters
        return acc

    calculate = make_calculate(width, max_iters, device)
    return (Pipeline(host="192.168.1.176")
            .emit(emit)
            .stage(calculate, nodes=2, workers=2, name="render")
            .stage(reduce_line, nodes=1, workers=1, name="reduce")
            .collect(ResultDetails(
                name="Mcollect",
                init=lambda: dict(points=0, white=0, black=0, total_iters=0),
                collect=fold,
            ))
            .build())


def _counts(result) -> str:
    # paper prints: points, whiteCount, blackCount, totalIters
    return (f"{result['points']}, {result['white']}, {result['black']}, "
            f"{result['total_iters']}")


def backend_options(backend: str) -> dict:
    """What ``build_application`` is given for ``backend`` beside the spec."""
    return {"preload": NODE_PRELOAD} if backend == "cluster" else {}


def main(argv=None) -> tuple[dict, dict]:
    """Run both parts; returns the two results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("backend", nargs="?", default="threads",
                    choices=("threads", "cluster"),
                    help="threads in this process, or node-loader "
                         "subprocesses over TCP")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch version)")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--lines", type=int, default=LINES)
    ap.add_argument("--iters", type=int, default=MAX_ITERATIONS)
    args = ap.parse_args(argv)

    spec = mandelbrot_spec(args.width, args.lines, args.iters,
                           device=args.device)
    print(f"parsed spec: {spec.nclusters} nodes x {spec.workers_per_node} "
          "workers\n")
    report = verify_spec(spec, num_objects=4)
    print(report.summary(), "\n")
    if not report.ok:
        raise RuntimeError("deployment must be provably deadlock/livelock free")

    builder = ClusterBuilder()
    print(builder.deployment_plan(spec).describe(), "\n")
    result = builder.build_application(
        spec, backend=args.backend, **backend_options(args.backend)).run()
    print(_counts(result))
    print()
    print(builder.timing.report())

    print("\n--- fluent two-stage pipeline (same workload, generalised "
          "spec API) ---\n")
    lines = max(args.lines // 4, 8)  # a smaller instance: this is the API demo
    pipe = fluent_spec(args.width, lines, args.iters, device=args.device)
    print("fluent pipeline: "
          + " -> ".join(f"{st.name}[{st.nclusters}x{st.workers_per_node}]"
                        for st in pipe.stages))
    report = verify_spec(pipe)
    print(report.summary(), "\n")
    if not report.ok:
        raise RuntimeError("the chained network must verify like the single hop")
    fluent = ClusterBuilder().build_application(
        pipe, backend=args.backend, **backend_options(args.backend)).run()
    print(_counts(fluent))
    if fluent["points"] != lines * args.width:
        raise RuntimeError(f"fluent pipeline lost points: {fluent['points']}")
    return result, fluent


if __name__ == "__main__":
    # Run the module under its package name, so that the work function
    # pickles as ``repro_torch.quickstart.Calculate``, which a node-loader
    # can import, and not as ``__main__.Calculate``, which it cannot.
    from repro_torch.quickstart import main as _main

    _main()
