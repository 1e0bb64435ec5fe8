"""Offline tools of the port: decontamination (``tools/decontam``)."""
