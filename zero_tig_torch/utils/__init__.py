"""Flow file IO, flow visualisation and utility helpers: the exports of
``zero_tig_tpu/utils/__init__.py`` (:1-38)."""

from .flow_io import (
    read_flo,
    read_flow_kitti,
    read_gen,
    read_pfm,
    write_flo,
    write_flow_kitti,
    write_pfm,
)
from .flow_viz import flow_to_image, make_colorwheel
from .misc import (
    count_parameters_in_mb,
    create_exp_dir,
    drop_path,
    forward_interpolate,
    save_checkpoint,
    show_pic,
    viz_flow_overlay,
)

__all__ = [
    "count_parameters_in_mb",
    "create_exp_dir",
    "drop_path",
    "flow_to_image",
    "forward_interpolate",
    "save_checkpoint",
    "show_pic",
    "viz_flow_overlay",
    "make_colorwheel",
    "read_flo",
    "read_flow_kitti",
    "read_gen",
    "read_pfm",
    "write_flo",
    "write_flow_kitti",
    "write_pfm",
]
