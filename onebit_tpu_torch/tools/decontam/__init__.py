"""Train/test decontamination (``janitor.Janitor``)."""
