"""Generate tables.inc for the C++ parse core from the Python source of
truth (bitstream/ctx_tables.py, bitstream/syntax.py) — guarantees both
parsers share identical constants."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from openhevc_tpu_torch.bitstream import ctx_tables as C          # noqa: E402
from openhevc_tpu_torch.bitstream import cabac as CB              # noqa: E402
from openhevc_tpu_torch.bitstream import syntax as S              # noqa: E402


def arr(name, ctype, vals, per_line=16):
    lines = [f"static const {ctype} {name}[{len(vals)}] = {{"]
    for i in range(0, len(vals), per_line):
        lines.append("    " + ", ".join(str(v) for v in
                                        vals[i:i + per_line]) + ",")
    lines.append("};")
    return "\n".join(lines)


def main():
    out = ["// AUTO-GENERATED by gen_tables.py — do not edit.", ""]
    # ctx offsets as #defines
    for name, off in C.CTX_OFFSET.items():
        out.append(f"#define CTX_{name.upper()} {off}")
    out.append(f"#define NUM_CONTEXTS {C.NUM_CONTEXTS}")
    out.append("")
    flat_init = [v for it in range(3) for v in C.INIT_VALUES[it]]
    out.append(arr("INIT_VALUES", "uint8_t", flat_init))
    lps = [v for row in CB.LPS_RANGE for v in row]
    out.append(arr("LPS_RANGE", "uint8_t", lps))
    out.append(arr("TRANS_LPS", "uint8_t", list(CB.TRANS_LPS)))
    out.append(arr("TRANS_MPS", "uint8_t", list(CB.TRANS_MPS)))
    # scan tables: for each scan type, 4x4 position lists (x,y interleaved)
    for sc, nm in ((S.SCAN_DIAG, "DIAG"), (S.SCAN_HORIZ, "HORIZ"),
                   (S.SCAN_VERT, "VERT")):
        vals = [c for xy in S._SCANS_4[sc] for c in xy]
        out.append(arr(f"SCAN4_{nm}", "uint8_t", vals))
    for n in (2, 4, 8):
        for sc, nm in ((S.SCAN_DIAG, "DIAG"), (S.SCAN_HORIZ, "HORIZ"),
                       (S.SCAN_VERT, "VERT")):
            vals = [c for xy in S._CG_SCANS[(sc, n)] for c in xy]
            out.append(arr(f"SCANCG{n}_{nm}", "uint8_t", vals))
    sig = [v for row in S.SIG_CTX_MAP for v in row]
    out.append(arr("SIG_CTX_MAP", "uint8_t", sig))
    out.append(arr("CHROMA_QP_TABLE", "uint8_t", list(S.CHROMA_QP_TABLE)))
    path = os.path.join(os.path.dirname(__file__), "tables.inc")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
