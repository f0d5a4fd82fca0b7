"""Generate ``ofasys_torch/csrc/host/unicode_tables.h`` (counterpart of
ofasys_tpu's generator): codepoint ranges for the three character classes
the GPT-2 pre-tokenizer pattern needs (\\p{L}, \\p{N}, \\s).

The ranges are extracted FROM the same `regex` module the Python tokenizer
uses (one findall pass over every codepoint), so the C++ scanner's
classification is exact-by-construction against the Python encoder.
Falls back to unicodedata when `regex` is unavailable.

Usage: python -m ofasys_torch.tools.gen_unicode_tables [out.h]
(default: rewrites csrc/host/unicode_tables.h)
"""

import os
import sys

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "csrc", "host", "unicode_tables.h")


def char_set(pattern_module, klass: str):
    all_cps = "".join(
        chr(cp) for cp in range(0x110000) if not (0xD800 <= cp <= 0xDFFF)
    )
    return {ord(c) for c in pattern_module.findall(klass, all_cps)}


def char_set_unicodedata(kind: str):
    import unicodedata

    out = set()
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        cat = unicodedata.category(chr(cp))
        if kind == "L" and cat.startswith("L"):
            out.add(cp)
        elif kind == "N" and cat.startswith("N"):
            out.add(cp)
        elif kind == "S" and (cat == "Zs" or chr(cp) in "\t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85"):
            out.add(cp)
    return out


def to_ranges(cps):
    rs = []
    for cp in sorted(cps):
        if rs and cp == rs[-1][1] + 1:
            rs[-1][1] = cp
        else:
            rs.append([cp, cp])
    return rs


def emit(name, ranges, out):
    out.append(f"static const uint32_t {name}[][2] = {{")
    line = "    "
    for a, b in ranges:
        piece = f"{{{a},{b}}},"
        if len(line) + len(piece) > 96:
            out.append(line)
            line = "    "
        line += piece
    out.append(line)
    out.append("};")
    out.append(f"static const size_t {name}_n = sizeof({name}) / sizeof({name}[0]);")
    out.append("")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_OUT
    try:
        import regex

        letters = char_set(regex, r"\p{L}")
        numbers = char_set(regex, r"\p{N}")
        spaces = char_set(regex, r"\s")
        src = f"regex module (unicode {getattr(regex, '__version__', '?')})"
    except ImportError:
        letters = char_set_unicodedata("L")
        numbers = char_set_unicodedata("N")
        spaces = char_set_unicodedata("S")
        src = "unicodedata fallback"

    out = [
        "// AUTO-GENERATED by ofasys_torch/tools/gen_unicode_tables.py — do not edit.",
        f"// Source: {src}; classes match the Python tokenizer's regex exactly.",
        "#pragma once",
        "#include <stdint.h>",
        "#include <stddef.h>",
        "",
    ]
    emit("UNI_LETTER", to_ranges(letters), out)
    emit("UNI_NUMBER", to_ranges(numbers), out)
    emit("UNI_SPACE", to_ranges(spaces), out)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {os.path.abspath(path)}: L={len(letters)} N={len(numbers)} S={len(spaces)} cps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
