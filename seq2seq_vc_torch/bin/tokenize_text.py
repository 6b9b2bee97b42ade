"""Build a token vocabulary from training text (mirrors
seq2seq_vc_tpu/bin/tokenize_text.py).

    python -m seq2seq_vc_torch.bin.tokenize_text --input text --output tokens.txt \
        --token_type phn --g2p g2p_en --cleaner tacotron --field 2-

Cleans and tokenises the chosen fields of each line, counts the tokens and
writes ``tokens.txt``: ``<blank>``, ``<unk>``, the tokens sorted, then
``<sos/eos>`` (the model's eos is the last id). Pure Python: no device.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter

from ..text import TextCleaner, build_tokenizer


def field2slice(field: str) -> slice:
    """'2-' -> slice(1, None); '1' -> slice(0, 1); '2-3' -> slice(1, 3)."""
    if "-" in field:
        lo, hi = field.split("-")
        return slice(int(lo) - 1 if lo else 0, int(hi) if hi else None)
    i = int(field) - 1
    return slice(i, i + 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Tokenize text and build vocabulary")
    parser.add_argument("--input", "-i", required=True)
    parser.add_argument("--output", "-o", required=True, help="tokens.txt path")
    parser.add_argument("--field", "-f", default="2-")
    parser.add_argument("--token_type", "-t", default="char")
    parser.add_argument("--delimiter", "-d", default=None)
    parser.add_argument("--cleaner", default=None)
    parser.add_argument("--g2p", default=None)
    parser.add_argument("--non_linguistic_symbols", default=None)
    parser.add_argument("--remove_non_linguistic_symbols", action="store_true")
    parser.add_argument("--cutoff", type=int, default=0)
    parser.add_argument("--vocabulary_size", type=int, default=0)
    parser.add_argument("--add_symbol", action="append", default=[])
    args = parser.parse_args(argv)

    cleaner = TextCleaner(args.cleaner) if args.cleaner else None
    tokenizer = build_tokenizer(
        token_type=args.token_type, non_linguistic_symbols=args.non_linguistic_symbols,
        remove_non_linguistic_symbols=args.remove_non_linguistic_symbols,
        delimiter=args.delimiter, g2p_type=args.g2p,
    )
    sl = field2slice(args.field)
    counter: Counter = Counter()
    with open(args.input, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(args.delimiter)
            text = (args.delimiter or " ").join(parts[sl])
            if cleaner is not None:
                text = cleaner(text)
            counter.update(tokenizer.text2tokens(text))

    tokens = [t for t, c in counter.most_common() if c > args.cutoff]
    if args.vocabulary_size > 0:
        tokens = tokens[: max(args.vocabulary_size - 3, 0)]
    # framing symbols: blank first, unk second, sos/eos last (espnet layout)
    out = ["<blank>", "<unk>"] + sorted(tokens) + ["<sos/eos>"]
    for sym in args.add_symbol:
        name, _, pos = sym.partition(":")
        out.insert(int(pos), name)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {len(out)} tokens to {args.output}")
    return out


if __name__ == "__main__":
    main()
