"""Normative CABAC context initialization constants (H.265 Tables 9-5..9-37).

Organized per syntax element as {name: (init_type0, init_type1, init_type2)}
where each entry is a tuple of 8-bit initValues, one per ctxInc. These are
specification constants shared by every conformant HEVC codec (cf. the
reference's flat array at hevc_cabac.c:158; we keep a per-element dict and
derive flat offsets programmatically).

init_type selection (9.3.2.2): I-slice -> 0; P-slice -> 2 if
cabac_init_flag else 1; B-slice -> 1 if cabac_init_flag else 2.
"""
from __future__ import annotations

CNU = 154  # "context not used" placeholder value from the spec tables

_L = {  # name -> 3 tuples of init values
    "sao_merge_flag": ((153,), (153,), (153,)),
    "sao_type_idx": ((200,), (185,), (160,)),
    "split_cu_flag": ((139, 141, 157), (107, 139, 126), (107, 139, 126)),
    "cu_transquant_bypass_flag": ((154,), (154,), (154,)),
    "cu_skip_flag": ((CNU, CNU, CNU), (197, 185, 201), (197, 185, 201)),
    "cu_qp_delta": ((154, 154, 154), (154, 154, 154), (154, 154, 154)),
    "pred_mode_flag": ((CNU,), (149,), (134,)),
    "part_mode": ((184, CNU, CNU, CNU), (154, 139, 154, 154),
                  (154, 139, 154, 154)),
    "prev_intra_luma_pred_flag": ((184,), (154,), (183,)),
    "intra_chroma_pred_mode": ((63, 139), (152, 139), (152, 139)),
    "merge_flag": ((CNU,), (110,), (154,)),
    "merge_idx": ((CNU,), (122,), (137,)),
    "inter_pred_idc": ((CNU,) * 5, (95, 79, 63, 31, 31), (95, 79, 63, 31, 31)),
    "ref_idx_l0": ((CNU, CNU), (153, 153), (153, 153)),
    "ref_idx_l1": ((CNU, CNU), (153, 153), (153, 153)),
    "abs_mvd_greater0_flag": ((CNU, CNU), (140, 198), (169, 198)),
    "abs_mvd_greater1_flag": ((CNU, CNU), (140, 198), (169, 198)),
    "mvp_l0_flag": ((CNU,), (168,), (168,)),
    "rqt_root_cbf": ((CNU,), (79,), (79,)),
    "split_transform_flag": ((153, 138, 138), (124, 138, 94), (224, 167, 122)),
    "cbf_luma": ((111, 141), (153, 111), (153, 111)),
    "cbf_cbcr": ((94, 138, 182, 154), (149, 107, 167, 154),
                 (149, 92, 167, 154)),
    "transform_skip_flag": ((139, 139), (139, 139), (139, 139)),
    "explicit_rdpcm_flag": ((139, 139), (139, 139), (139, 139)),
    "explicit_rdpcm_dir_flag": ((139, 139), (139, 139), (139, 139)),
    "last_sig_coeff_x_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93)),
    "last_sig_coeff_y_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93)),
    "coded_sub_block_flag": ((91, 171, 134, 141), (121, 140, 61, 154),
                             (121, 140, 61, 154)),
    "sig_coeff_flag": (
        (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111,
         141, 111),
        (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140,
         140, 140),
        (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140,
         140, 140)),
    "coeff_abs_level_greater1_flag": (
        (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
        (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182),
        (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182)),
    "coeff_abs_level_greater2_flag": (
        (138, 153, 136, 167, 152, 152), (107, 167, 91, 122, 107, 167),
        (107, 167, 91, 107, 107, 167)),
    "log2_res_scale_abs": ((154,) * 8, (154,) * 8, (154,) * 8),
    "res_scale_sign_flag": ((154, 154), (154, 154), (154, 154)),
    "cu_chroma_qp_offset_flag": ((154,), (154,), (154,)),
    "cu_chroma_qp_offset_idx": ((154,), (154,), (154,)),
}

# Deterministic flat layout: alphabetical-independent, fixed insertion order.
CTX_ORDER = list(_L.keys())
CTX_OFFSET: dict[str, int] = {}
_off = 0
for _name in CTX_ORDER:
    CTX_OFFSET[_name] = _off
    _off += len(_L[_name][0])
NUM_CONTEXTS = _off

INIT_VALUES: tuple[tuple[int, ...], ...] = tuple(
    tuple(v for name in CTX_ORDER for v in _L[name][it]) for it in range(3)
)


def init_states(init_type: int, qp: int) -> list[int]:
    """All context states for a slice (packed (pStateIdx<<1)|valMps)."""
    from .cabac import init_context_state
    vals = INIT_VALUES[init_type]
    return [init_context_state(v, qp) for v in vals]
