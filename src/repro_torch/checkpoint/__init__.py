"""Crash consistency of the summarizers: the checkpointer, the write-ahead
chunk journal and save / restore / recover over both (port of the JAX
package's ``repro.checkpoint``, with its on-disk format)."""
from repro_torch.checkpoint import checkpointer, journal, summary
from repro_torch.checkpoint.journal import ChunkJournal
from repro_torch.checkpoint.summary import (KEEP_EPOCHS, ConfigMismatchError,
                                            recover_summarizer,
                                            restore_summarizer,
                                            save_summarizer)

__all__ = ["ChunkJournal", "ConfigMismatchError", "KEEP_EPOCHS",
           "checkpointer", "journal", "recover_summarizer",
           "restore_summarizer", "save_summarizer", "summary"]
