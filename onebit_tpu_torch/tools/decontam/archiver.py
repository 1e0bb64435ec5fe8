"""Zstd jsonl archives for decontamination corpora.

The reference's ``decontamination/archiver.py`` (Archive/Reader/TextArchive/
TextReader/ZStdTextReader, :21-161) moves training corpora and pre-built
n-gram buckets as zstd-compressed jsonl ("lm_dataformat") and decompresses
by shelling out to the ``zstd`` binary.  This equivalent keeps the same
on-disk formats (so the reference pipeline's files interchange) but streams
through the ``zstandard`` Python API — no shell-outs, no temp files, and
readers work as iterators with constant memory.

A copy of ``onebit_tpu/tools/decontam/archiver.py``, with ``zstandard``
imported where it is used, so that the module imports on a machine without
it.
"""

from __future__ import annotations

import io
import json
import os
from typing import Iterable, Iterator, Tuple, Union


class Archive:
    """Write ``{"text": ..., "meta": ...}`` jsonl into a zstd stream
    (reference archiver.py:21-42 format)."""

    def __init__(self, file_path: str, compression_level: int = 3):
        self.file_path = file_path
        dir_name = os.path.dirname(file_path)
        if dir_name:
            os.makedirs(dir_name, exist_ok=True)
        import zstandard
        self._fh = open(file_path, "wb")
        cctx = zstandard.ZstdCompressor(level=compression_level)
        self._writer = cctx.stream_writer(self._fh)

    def add_data(self, data: str, meta: dict = None) -> None:
        obj = {"text": data, "meta": meta or {}}
        self._writer.write(json.dumps(obj).encode("utf-8") + b"\n")

    def commit(self) -> None:
        import zstandard
        self._writer.flush(zstandard.FLUSH_FRAME)
        self._fh.flush()
        self._fh.close()


class Reader:
    """Stream documents back out of an ``Archive`` file
    (reference archiver.py:45-73 semantics incl. paragraph auto-join)."""

    def read(self, file: str, get_meta: bool = False,
             autojoin_paragraphs: bool = True, para_joiner: str = "\n\n"
             ) -> Iterator[Union[str, Tuple[str, dict]]]:
        import zstandard
        with open(file, "rb") as fh:
            dctx = zstandard.ZstdDecompressor()
            stream = io.TextIOWrapper(
                io.BufferedReader(dctx.stream_reader(fh)), encoding="utf-8")
            for line in stream:
                if not line.strip():
                    continue
                ob = json.loads(line)
                if isinstance(ob, str):
                    # legacy naive jsonl: the object IS the text
                    yield ob
                    continue
                text = ob["text"]
                if autojoin_paragraphs and isinstance(text, list):
                    text = para_joiner.join(text)
                if get_meta:
                    yield text, ob.get("meta", {})
                else:
                    yield text


class TextArchive:
    """Plain newline-separated text archive (reference archiver.py:76-91)."""

    def __init__(self, file_path: str, mode: str = "ab"):
        self.file_path = file_path
        dir_name = os.path.dirname(file_path)
        if dir_name:
            os.makedirs(dir_name, exist_ok=True)
        self._fh = open(file_path, mode)

    def add_data(self, data: str) -> None:
        self._fh.write(data.encode("utf-8") + b"\n")

    def commit(self) -> None:
        self._fh.flush()
        self._fh.close()


def read_text_lines(file_path: str) -> Iterator[str]:
    """Line iterator over a plain text archive (reference TextReader.read)."""
    with open(file_path, "r", encoding="utf-8") as fh:
        for line in fh:
            yield line.rstrip("\n")


class ZstTextReader:
    """Line iterator over a zstd-compressed text file — the sorted n-gram
    bucket format (``ngrams_*.bkt.txt.sorted.zst``).  The reference
    decompresses the whole file to disk via ``os.system("zstd -d ...")``
    (archiver.py:150-161); this streams it instead.
    """

    def __init__(self, file: str):
        self.file = file

    def read(self) -> Iterator[str]:
        import zstandard
        with open(self.file, "rb") as fh:
            dctx = zstandard.ZstdDecompressor()
            stream = io.TextIOWrapper(
                io.BufferedReader(dctx.stream_reader(fh)), encoding="utf-8")
            for line in stream:
                yield line.rstrip("\n")

    # alias kept for drop-in parity with the reference call site
    read_tqdm = read


def write_sorted_ngrams(file_path: str, lines: Iterable[str],
                        compression_level: int = 3) -> None:
    """Write a sorted n-gram bucket file in the reference's ``.sorted.zst``
    format (one ``"<ngram> <doc_id>"`` per line, lexicographically sorted)."""
    import zstandard
    dir_name = os.path.dirname(file_path)
    if dir_name:
        os.makedirs(dir_name, exist_ok=True)
    with open(file_path, "wb") as fh:
        cctx = zstandard.ZstdCompressor(level=compression_level)
        with cctx.stream_writer(fh) as writer:
            for line in lines:
                writer.write(line.encode("utf-8") + b"\n")
