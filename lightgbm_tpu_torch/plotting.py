"""Plotting utilities.

Re-implements the reference plotting surface (reference:
python-package/lightgbm/plotting.py — plot_importance :37,
plot_split_value_histogram :144, plot_metric :231, plot_tree :549 /
create_tree_digraph :461) on top of this package's Booster
introspection API. Matplotlib/graphviz are imported lazily so the
training stack never depends on them.
"""
from __future__ import annotations

from copy import deepcopy
from io import BytesIO
from typing import Optional

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel


# ---------------------------------------------------------------------------
# shared axis helpers
# ---------------------------------------------------------------------------

def _resolve_booster(obj) -> Booster:
    if isinstance(obj, LGBMModel):
        return obj.booster_
    if isinstance(obj, Booster):
        return obj
    raise TypeError("booster must be Booster or LGBMModel.")


def _require_pair(value, name: str):
    if not isinstance(value, tuple) or len(value) != 2:
        raise TypeError(f"{name} must be a tuple of 2 elements.")
    return value


def _new_axes(figsize, dpi):
    import matplotlib.pyplot as plt
    if figsize is not None:
        _require_pair(figsize, "figsize")
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def _padded(lo: float, hi: float, pad: float):
    span = hi - lo
    return (lo - span * pad, hi + span * pad)


def _finish_axes(ax, *, title, xlabel, ylabel, grid, ylim=None):
    if ylim is not None:
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _num_text(value, precision: int) -> str:
    return f"{value:.{precision}f}" if isinstance(value, float) else str(value)


# ---------------------------------------------------------------------------
# public plots
# ---------------------------------------------------------------------------

def plot_importance(booster, ax=None, height: float = 0.2, xlim=None,
                    ylim=None, title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Horizontal bar chart of per-feature importance
    (reference plotting.py:37)."""
    bst = _resolve_booster(booster)
    scores = bst.feature_importance(importance_type=importance_type)
    if not len(scores):
        raise ValueError("Booster's feature_importance is empty.")
    names = bst.feature_name()

    ranked = sorted(zip(scores, names))          # ascending for barh
    if ignore_zero:
        ranked = [p for p in ranked if p[0] > 0]
    if max_num_features is not None and max_num_features > 0:
        ranked = ranked[-max_num_features:]
    values = [p[0] for p in ranked]
    labels = [p[1] for p in ranked]

    if ax is None:
        ax = _new_axes(figsize, dpi)
    positions = np.arange(len(ranked))
    ax.barh(positions, values, height=height, align="center", **kwargs)
    for pos, val in zip(positions, values):
        ax.text(val + 1, pos, _num_text(val, precision)
                if importance_type == "gain" else str(val), va="center")
    ax.set_yticks(positions)
    ax.set_yticklabels(labels)

    if xlim is not None:
        _require_pair(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_xlim(xlim)
    return _finish_axes(ax, title=title, xlabel=xlabel, ylabel=ylabel,
                        grid=grid, ylim=ylim)


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with @index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Bar chart of where the model split a feature
    (reference plotting.py:144)."""
    bst = _resolve_booster(booster)
    counts, edges = bst.get_split_value_histogram(feature, bins=bins,
                                                  xgboost_style=False)
    if not np.any(counts):
        raise ValueError(f"Cannot plot split value histogram, "
                         f"because feature {feature} was not used in splitting")

    if ax is None:
        ax = _new_axes(figsize, dpi)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.bar(centers, counts, width=width_coef * (edges[1] - edges[0]),
           align="center", **kwargs)

    if xlim is not None:
        _require_pair(xlim, "xlim")
    else:
        xlim = _padded(edges[0], edges[-1], 0.2)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        ylim = (0, max(counts) * 1.1)
    ax.set_xlim(xlim)
    if title is not None:
        kind = "name" if isinstance(feature, str) else "index"
        title = title.replace("@feature@", str(feature)) \
                     .replace("@index/name@", kind)
    return _finish_axes(ax, title=title, xlabel=xlabel, ylabel=ylabel,
                        grid=grid, ylim=ylim)


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize=None, dpi=None, grid: bool = True):
    """Line chart of a recorded metric across iterations per dataset
    (reference plotting.py:231)."""
    if isinstance(booster, LGBMModel):
        history = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        history = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError("booster must be dict or LGBMModel. To use "
                        "plot_metric with Booster type, first record the "
                        "metrics using record_evaluation callback then pass "
                        "that to plot_metric as argument `booster`")
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not history:
        raise ValueError("eval results cannot be empty.")

    if dataset_names is None:
        names = list(history.keys())
    elif isinstance(dataset_names, (list, tuple, set)):
        names = list(dataset_names)
    else:
        raise ValueError("dataset_names should be iterable and cannot be empty")

    first_series = history[names[0]]
    if metric is None:
        if len(first_series) > 1:
            raise ValueError("more than one metric available, pick one with "
                             "the 'metric' parameter")
        metric = next(iter(first_series))
    elif metric not in first_series:
        raise ValueError("No given metric in eval results.")

    if ax is None:
        ax = _new_axes(figsize, dpi)
    lo, hi, n_iter = np.inf, -np.inf, 0
    for name in names:
        series = history[name][metric]
        n_iter = max(n_iter, len(series))
        lo, hi = min(lo, min(series)), max(hi, max(series))
        ax.plot(range(len(series)), series, label=name)
    ax.legend(loc="best")

    if xlim is not None:
        _require_pair(xlim, "xlim")
    else:
        xlim = (0, n_iter)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        ylim = _padded(lo, hi, 0.2)
    ax.set_xlim(xlim)
    return _finish_axes(ax, title=title, xlabel=xlabel,
                        ylabel=metric if ylabel == "auto" else ylabel,
                        grid=grid, ylim=ylim)


# ---------------------------------------------------------------------------
# tree rendering
# ---------------------------------------------------------------------------

def _node_label(node: dict, feature_names, precision: int) -> str:
    feat = node["split_feature"]
    shown = feature_names[feat] if feature_names is not None \
        else f"feature <B>{feat}</B>"
    if feature_names is not None:
        shown = f"<B>{shown}</B>"
    thr = _num_text(node["threshold"], precision)
    return f"<{shown} {node['decision_type']} <B>{thr}</B>>"


def _leaf_label(node: dict, show_info, precision: int) -> str:
    body = (f"leaf {node['leaf_index']}: "
            f"<B>{_num_text(node['leaf_value'], precision)}</B>")
    if "leaf_count" in show_info and "leaf_count" in node:
        body += f"<br/>count: {node['leaf_count']}"
    return f"<{body}>"


def _render_subtree(graph, node: dict, feature_names, show_info,
                    precision: int, parent: Optional[str], edge: Optional[str]):
    is_split = "split_index" in node
    if is_split:
        gv_name = f"split{node['split_index']}"
        graph.node(gv_name, label=_node_label(node, feature_names, precision))
    else:
        gv_name = f"leaf{node['leaf_index']}"
        graph.node(gv_name, label=_leaf_label(node, show_info, precision))
    if parent is not None:
        graph.edge(parent, gv_name, edge)
    if is_split:
        _render_subtree(graph, node["left_child"], feature_names, show_info,
                        precision, gv_name, "yes")
        _render_subtree(graph, node["right_child"], feature_names, show_info,
                        precision, gv_name, "no")


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, orientation: str = "horizontal",
                        **kwargs):
    """Graphviz Digraph of one tree (reference plotting.py:461)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz and restart your "
                          "session to plot tree.")
    bst = _resolve_booster(booster)
    dump = bst.dump_model()
    trees = dump["tree_info"]
    if tree_index >= len(trees):
        raise IndexError("tree_index is out of range.")
    graph = Digraph(**kwargs)
    graph.attr("graph", nodesep="0.05", ranksep="0.3",
               rankdir="LR" if orientation == "horizontal" else "TB")
    _render_subtree(graph, trees[tree_index]["tree_structure"],
                    dump.get("feature_names"), show_info or [],
                    precision, None, None)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: int = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree into a matplotlib axes via graphviz PNG
    (reference plotting.py:549)."""
    import matplotlib.image as mpimg

    if ax is None:
        ax = _new_axes(figsize, dpi)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    ax.imshow(mpimg.imread(BytesIO(graph.pipe(format="png"))))
    ax.axis("off")
    return ax
