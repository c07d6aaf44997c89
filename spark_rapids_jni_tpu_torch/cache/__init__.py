"""The cache tier of the port. Only the table generation stamps
(``tablegen``) are ported: the plan tier's statistics key their sketches
on them. The plan and subresult caches wait for the memory governor
(ROADMAP.md, Open items, section 1, item 12b)."""

from . import tablegen  # noqa: F401
