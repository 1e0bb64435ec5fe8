"""Train/test decontamination: ``janitor.Janitor`` (the 13-gram scan, with
its C core), ``overlap.get_train_overlap`` (pre-built n-gram buckets) and
``archiver`` (zstd jsonl archives)."""
