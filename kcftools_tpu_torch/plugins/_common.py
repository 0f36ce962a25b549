import re
import sys

from ..utils.logger import Logger


def get_command_line() -> str:
    """Recorded into ##CMD= (reference embeds sun.java.command)."""
    return " ".join(["kcftools"] + sys.argv[1:])


def clean_sample_name(sample: str, class_name: str) -> str:
    sanitized = re.sub(r'[\\/:*?"<>|]', "_", sample)
    if sanitized != sample:
        Logger.warning(
            class_name,
            f"Sample name contains invalid characters, changed to: {sanitized}",
        )
    return sanitized
