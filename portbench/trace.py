"""What a traced run reads from torch.profiler's raw (kineto) events: the
device's kernels and copies, the host's launch calls, and the host ranges
that portbench opens around the program's entry points (`RANGES`)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

# host calls that put work on the device: kernel launches and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
PREFIX = "portbench."


@dataclass
class TraceView:
    window_s: float
    device: list = field(default_factory=list)    # (name, start, end, corr)
    launches: list = field(default_factory=list)  # (start, corr)
    runtime: list = field(default_factory=list)   # (start, corr): any call
    ranges: list = field(default_factory=list)    # (start, end, name)

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "TraceView":
        view = cls(window_s=window_s)
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if "CUDA" in str(e.device_type()):
                if name.startswith(PREFIX) or (
                        hasattr(e, "is_user_annotation")
                        and e.is_user_annotation()):
                    continue
                view.device.append((name, start, start + dur,
                                    e.correlation_id()))
            elif name.startswith(("cuda", "cu")):
                view.runtime.append((start, e.correlation_id()))
                if name in LAUNCH_CALLS:
                    view.launches.append((start, e.correlation_id()))
            elif name.startswith(PREFIX):
                view.ranges.append((start, start + dur, name))
        view.device.sort(key=lambda d: d[1])
        view.launches.sort()
        view.ranges.sort()
        return view

    def busy_ns(self) -> int:
        """The union of the device's kernel and copy intervals."""
        total, cur_s, cur_e = 0, None, None
        for _, s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def kernel_ns(self, *names: str) -> tuple[int, int]:
        """(device ns, count) of the kernels whose name holds any of
        `names`."""
        hit = [e - s for n, s, e, _ in self.device
               if any(k in n for k in names)]
        return sum(hit), len(hit)

    def range_at(self, t: int):
        """The innermost portbench range holding host time t, or None:
        the latest-starting one of the few ranges that began before t."""
        i = bisect.bisect_right(self.ranges, (t, float("inf"), ""))
        for s, e, n in reversed(self.ranges[max(0, i - 64):i]):
            if e >= t:
                return (s, e, n)
        return None

    def device_ns_in(self, name: str) -> tuple[int, int]:
        """(device ns, count) of the kernels and copies whose launch the
        host made inside a range `name` (ranges of one name never nest)."""
        spans = [(s, e) for s, e, n in self.ranges if n == name]
        starts = [s for s, _ in spans]
        inside = set()
        for t, corr in self.runtime:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                inside.add(corr)
        hit = [e - s for _, s, e, corr in self.device if corr in inside]
        return sum(hit), len(hit)

    def top_ops(self, k: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by: dict[str, int] = {}
        for n, s, e, _ in self.device:
            by[n] = by.get(n, 0) + e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], ns * 1e-9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time summed by what the host was doing when it ended
        it: the innermost portbench range around the launch of the work
        that followed each gap.  [[range, seconds]], largest first."""
        launch_at = {corr: t for t, corr in self.runtime}
        by: dict[str, int] = {}
        last_end = None
        for _, s, e, corr in self.device:
            if last_end is not None and s > last_end:
                t = launch_at.get(corr)
                r = self.range_at(t) if t is not None else None
                key = r[2] if r else "outside portbench ranges"
                by[key] = by.get(key, 0) + s - last_end
            last_end = e if last_end is None else max(last_end, e)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns * 1e-9] for n, ns in top]
