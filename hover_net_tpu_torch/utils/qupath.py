"""QuPath v0.2.3 TSV export (convert_format.py:19-50 contract).

The port's copy of hover_net_tpu/utils/qupath.py (same names, same
behaviour).
"""

from __future__ import annotations

import numpy as np


def rgb_to_int(rgb):
    r, g, b = rgb
    return (int(r) << 16) + (int(g) << 8) + int(b)


def to_qupath(file_path, nuc_pos_list, nuc_type_list, type_info_dict):
    """Write x/y/class/name/color rows for QuPath import."""
    nuc_pos_list = np.asarray(nuc_pos_list)
    nuc_type_list = np.asarray(nuc_type_list)
    assert nuc_pos_list.shape[0] == nuc_type_list.shape[0]
    with open(file_path, "w") as f:
        f.write("x\ty\tclass\tname\tcolor\n")
        for pos, typ in zip(nuc_pos_list, nuc_type_list):
            name, colour = type_info_dict[int(typ)]
            f.write(f"{pos[0]}\t{pos[1]}\t\t{name}\t{rgb_to_int(colour)}\n")
