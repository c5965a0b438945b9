"""Task-type vocabulary for the multimodal conditioning prefix.

Parity target: the reference ``TaskType`` enum (src/utils.py:82-89) — the five
conditioning tasks that select the leading control token of the encoder input.
"""


class TaskType:
    AFTER = "after"
    BEFORE = "before"
    INTENT = "intent"
    CAPTION = "caption"
    REGION_CAPTION = "region_caption"

    ALL_TYPES = {AFTER, BEFORE, INTENT, CAPTION, REGION_CAPTION}
