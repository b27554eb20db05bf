"""Training and validation figures: the port's own copy of
``lss_carla_tpu/utils/viz.py`` (the reference's 3-row wandb figure).

Row 1: the camera views (min-max rescaled); row 2: BEV ground truth, the
sigmoid prediction and a red/green/yellow GT-prediction overlay, as the
reference draws them (``train_simbev.py:268-329``), with the ego-vehicle
box in every BEV panel and metric axes (reference ``explore.py:310-330``
and ``add_ego``, ``tools.py:273-284``). Host-side numpy and matplotlib
only; matplotlib is imported where a figure is drawn.
"""

from __future__ import annotations

import numpy as np

CAM_NAMES = ['FRONT_LEFT', 'FRONT', 'FRONT_RIGHT',
             'BACK_LEFT', 'BACK', 'BACK_RIGHT']

# reference ego footprint (tools.py:273-284): 4.084 m long (+0.5 m forward
# offset), 1.85 m wide
EGO_L, EGO_W, EGO_OFF = 4.084, 1.85, 0.5


def add_ego_box(ax, color="#76b900"):
    """Draw the ego-vehicle footprint on a metric BEV axes where plot-x is
    ego Y (left/right) and plot-y is ego X (forward): the orientation of an
    (X, Y)-indexed grid under ``imshow(origin='lower')``."""
    ys = np.array([-EGO_W / 2, EGO_W / 2, EGO_W / 2, -EGO_W / 2])
    xs = np.array([-EGO_L / 2, -EGO_L / 2, EGO_L / 2, EGO_L / 2]) + EGO_OFF
    ax.fill(ys, xs, color)


def _bev_axes(ax):
    """Metric labels for an (X, Y)-indexed grid: rows (plot-y) are ego X."""
    ax.set_xlabel("Y (m)", fontsize=10)
    ax.set_ylabel("X (m, forward)", fontsize=10)
    ax.grid(True, alpha=0.3)
    add_ego_box(ax)


def make_bev_figure(cam_imgs: np.ndarray, gt: np.ndarray,
                    pred_sigmoid: np.ndarray, title: str = "",
                    extent=(-50.0, 50.0, -50.0, 50.0), map_draw=None):
    """cam_imgs (N, 3, H, W), normalised or uint8; gt and pred (X, Y) in
    [0, 1].

    ``extent``: metric bounds (ymin, ymax, xmin, xmax) of the BEV grid.
    ``map_draw``: optional ``f(ax)`` drawing a static-map underlay onto the
    prediction panel (reference ``explore.py:353-358``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = cam_imgs.shape[0]
    fig = plt.figure(figsize=(20, 12))
    for i in range(n):
        ax = plt.subplot(3, max(n, 1), i + 1)
        img = cam_imgs[i].transpose(1, 2, 0).astype(np.float32)
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        ax.imshow(img)
        ax.set_title(CAM_NAMES[i] if i < len(CAM_NAMES) else f"CAM{i}",
                     fontsize=10, fontweight="bold")
        ax.axis("off")

    for k, (data, name) in enumerate(
            [(gt, "BEV Ground Truth"), (pred_sigmoid, "BEV Prediction")]):
        ax = plt.subplot(3, 3, 7 + k)
        ax.imshow(data, cmap="hot", vmin=0, vmax=1, origin="lower",
                  extent=list(extent))
        if map_draw is not None and name == "BEV Prediction":
            map_draw(ax)
            ax.set_xlim(extent[0], extent[1])
            ax.set_ylim(extent[2], extent[3])
        ax.set_title(name, fontsize=12, fontweight="bold")
        _bev_axes(ax)

    ax = plt.subplot(3, 3, 9)
    overlay = np.zeros((*gt.shape, 3))
    overlay[..., 0] = gt
    overlay[..., 1] = pred_sigmoid
    ax.imshow(overlay, origin="lower", extent=list(extent))
    ax.set_title("Overlay (GT=Red, Pred=Green, Match=Yellow)", fontsize=12,
                 fontweight="bold")
    _bev_axes(ax)

    if title:
        plt.suptitle(title, fontsize=14, fontweight="bold")
    plt.tight_layout()
    return fig
