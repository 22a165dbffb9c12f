from .checkpointer import (AsyncSave, CorruptCheckpointError, latest_step,
                           restore, restore_latest, save, save_async)

__all__ = ["AsyncSave", "CorruptCheckpointError", "latest_step", "restore",
           "restore_latest", "save", "save_async"]
