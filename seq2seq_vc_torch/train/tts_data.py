"""TTS data (mirrors seq2seq_vc_tpu/train/tts_data.py): a 2-column text
file, the cleaner, tokenizer and token-id converter of ``text/``, and the
target mels (``make_loader``: an scp of ``.npy`` paths, an scp of HDF5
entries or a dump directory of ``.h5`` files) -> (token ids, mel) items,
and their collater."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..text import TextCleaner, TokenIDConverter, build_tokenizer
from .data import make_loader, pad_batch


def read_2column_text(path: str) -> Dict[str, str]:
    """{utt_id: text} of a file of ``<utt_id> <text>`` lines (a bare id
    gives ""); a duplicated id raises."""
    data: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for linenum, line in enumerate(f, 1):
            sps = line.rstrip().split(maxsplit=1)
            k, v = (sps[0], "") if len(sps) == 1 else sps
            if k in data:
                raise RuntimeError(f"{k} is duplicated ({path}:{linenum})")
            data[k] = v
    return data


class TTSDataset:
    """Items ``{"utt_id", "text": int32 token ids, "trg_feat": float32
    mel}`` of the utterances that have both a text and a mel."""

    def __init__(self, root_dir: str, text_path: str, non_linguistic_symbols, cleaner, g2p,
                 token_list, token_type: str, feat_key: str = "mel",
                 allow_cache: bool = False):
        self.text_cleaner = TextCleaner(cleaner)
        self.tokenizer = build_tokenizer(token_type=token_type,
                                         non_linguistic_symbols=non_linguistic_symbols,
                                         g2p_type=g2p)
        self.token_id_converter = TokenIDConverter(token_list, unk_symbol="<unk>")
        self.mels = make_loader(root_dir, feat_key)
        self.texts = read_2column_text(text_path)
        self.utt_ids = sorted(set(self.mels.keys()) & set(self.texts.keys()))
        if not self.utt_ids:
            raise ValueError("no utterances with both mel and text")
        self._cache: Optional[Dict[int, Any]] = {} if allow_cache else None

    def length(self, idx: int, key: str = "trg_feat") -> int:
        """The mel's frame count, from storage metadata (the loader's sort
        key; the JAX loader sorts this dataset by the same lengths)."""
        return self.mels.length(self.utt_ids[idx])

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        utt = self.utt_ids[idx]
        tokens = self.tokenizer.text2tokens(self.text_cleaner(self.texts[utt]))
        item = {
            "utt_id": utt,
            "text": np.asarray(self.token_id_converter.tokens2ids(tokens), np.int32),
            "trg_feat": np.asarray(self.mels[utt], np.float32),
        }
        if self._cache is not None:
            self._cache[idx] = item
        return item


class ARTTSCollater:
    """Pads the token ids (the model appends eos itself) to a multiple of
    ``pad_multiple`` and the mels to one of ``pad_multiple`` and the
    reduction factor; a mel's stop labels are 1 from its last frame on."""

    def __init__(self, pad_multiple: int = 32, reduction_factor: int = 1):
        self.src_multiple = pad_multiple
        self.trg_multiple = int(np.lcm(pad_multiple, max(reduction_factor, 1)))

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        xs = [b["text"] for b in batch]
        ys = [b["trg_feat"] for b in batch]
        olens = np.array([y.shape[0] for y in ys], np.int32)
        ys = pad_batch(ys, self.trg_multiple)
        return {
            "xs": pad_batch(xs, self.src_multiple),
            "ilens": np.array([x.shape[0] for x in xs], np.int32),
            "ys": ys,
            "olens": olens,
            "labels": (np.arange(ys.shape[1])[None, :] >= olens[:, None] - 1).astype(np.float32),
            "utt_ids": [b["utt_id"] for b in batch],
        }
