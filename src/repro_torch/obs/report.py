"""Exploration->exploitation rendering over selection telemetry (a copy of
the JAX package's ``obs/report.py``).

The paper's dynamical claim is that AdaGradSelect samples blocks broadly
early (Dirichlet prior + epsilon-greedy) and concentrates on the
high-signal blocks as cumulative gradient norms separate. ``summarize``
bins the [T, num_blocks] selection series into time windows and computes
per-window selection rates and the normalized entropy of the selection
distribution; ``render`` draws it as a unicode heatmap (blocks x time)
with the entropy trend and a one-line verdict. Works for any selection
policy (``adagradselect``, ``lisa``, ``grass``, ...) — the series is just
masks.
"""
from __future__ import annotations

import numpy as np

_SHADES = " ▁▂▃▄▅▆▇█"


def summarize(masks: np.ndarray, bins: int = 12) -> dict:
    """-> {bins, edges, rates [nb, bins], entropy [bins], mean_selected}.

    ``rates[b, w]`` is block b's selection rate inside time window w;
    ``entropy[w]`` is the entropy of the per-window selection distribution
    normalized to [0, 1] (1 = uniform exploration, -> 0 = concentrated
    exploitation). Windows are equal step spans (the last may be short).
    """
    masks = np.asarray(masks)
    if masks.ndim != 2 or not masks.size:
        raise ValueError(f"need a [T, num_blocks] mask series, got shape "
                         f"{masks.shape}")
    t, nb = masks.shape
    bins = max(1, min(int(bins), t))
    edges = np.linspace(0, t, bins + 1).astype(int)
    rates = np.zeros((nb, bins))
    entropy = np.zeros((bins,))
    for w in range(bins):
        window = masks[edges[w]:edges[w + 1]]
        rates[:, w] = window.mean(axis=0)
        total = rates[:, w].sum()
        if total > 0 and nb > 1:
            p = rates[:, w] / total
            nz = p[p > 0]
            entropy[w] = float(-(nz * np.log(nz)).sum() / np.log(nb))
    return {"bins": bins, "edges": edges.tolist(), "rates": rates,
            "entropy": entropy,
            "mean_selected": float(masks.sum(axis=1).mean())}


def _verdict(entropy: np.ndarray) -> str:
    third = max(1, len(entropy) // 3)
    early, late = float(np.mean(entropy[:third])), \
        float(np.mean(entropy[-third:]))
    if early - late > 0.05:
        trend = (f"exploration->exploitation: selection entropy "
                 f"{early:.2f} -> {late:.2f} (concentrating)")
    elif late - early > 0.05:
        trend = (f"selection entropy {early:.2f} -> {late:.2f} "
                 f"(broadening over time)")
    else:
        trend = (f"selection entropy steady at ~{late:.2f} "
                 f"(schedule/uniform policy)")
    return trend


def render(masks: np.ndarray, bins: int = 12, counts=None) -> str:
    """Heatmap string: one row per block, one column per time window,
    shaded by that window's selection rate; entropy row + verdict below."""
    s = summarize(masks, bins)
    rates, entropy = s["rates"], s["entropy"]
    nb, nbins = rates.shape
    lines = [f"selection heatmap — {masks.shape[0]} steps x {nb} blocks, "
             f"{nbins} windows (column = "
             f"~{masks.shape[0] / nbins:.0f} steps)"]
    counts = (np.asarray(masks).sum(axis=0) if counts is None
              else np.asarray(counts))
    for b in range(nb):
        cells = "".join(_SHADES[int(round(r * (len(_SHADES) - 1)))]
                        for r in np.clip(rates[b], 0, 1))
        lines.append(f"  block {b:3d} |{cells}| "
                     f"selected {int(counts[b])}x")
    ent = "".join(_SHADES[int(round(e * (len(_SHADES) - 1)))]
                  for e in np.clip(entropy, 0, 1))
    lines.append(f"  entropy   |{ent}|")
    lines.append(f"  {_verdict(entropy)}")
    return "\n".join(lines)


def render_selection_trace(trace, bins: int = 12) -> str:
    """Render a live ``SelectionTrace`` (or one rebuilt from a snapshot)."""
    if not len(trace):
        return "selection telemetry: no steps recorded (obs enabled?)"
    return render(trace.masks(), bins=bins, counts=trace.counts)


def render_metrics(snapshot: dict) -> str:
    """Flat text table of a ``registry.snapshot()`` document (histograms
    show count/mean/p50/p95/p99)."""
    lines = []
    for subsystem in sorted(k for k in snapshot if k != "selection"):
        lines.append(f"[{subsystem}]")
        for name, value in sorted(snapshot[subsystem].items()):
            if isinstance(value, dict) and "p50" in value:
                lines.append(
                    f"  {name:32s} n={value['count']:<8d} "
                    f"mean={value['mean']:.1f} p50={value['p50']:.1f} "
                    f"p95={value['p95']:.1f} p99={value['p99']:.1f}")
            else:
                lines.append(f"  {name:32s} {value}")
    return "\n".join(lines) if lines else "(no metrics recorded)"
