"""Concept-list parsing and prompt expansion.

Reproduces the public CLI semantics of the reference trainscripts
(``trainscripts/uce_sd_erase.py:134-190``): ``;``-separated concept lists,
guide-concept defaulting ('' for objects, 'art' for art), single-guide
broadcast, and the five-template prompt expansion.
"""

from __future__ import annotations

ART_TEMPLATES = (
    "painting by {}",
    "art by {}",
    "artwork by {}",
    "picture by {}",
    "style of {}",
)

OBJECT_TEMPLATES = (
    "image of {}",
    "photo of {}",
    "portrait of {}",
    "picture of {}",
    "painting of {}",
)


def parse_concepts(text: str | None) -> list[str]:
    """Split a ``;``-separated concept string, stripping whitespace.

    ``@path`` loads the concept list from a file instead: either a JSON
    array (the format of the vendored ``data/info/erased-*.txt`` lists,
    which are the exact concept sets behind the paper's erasure-scale
    experiments) or newline-separated text. This wires the corpus into
    the edit CLIs — e.g. ``--edit_concepts
    "@data/info/erased-100artists-towards_art-preserve_true-sd_1_4-method_replace.txt"``.
    """
    if text is None:
        return []
    if text.startswith("@"):
        import json

        with open(text[1:], "r", encoding="utf-8") as f:
            raw = f.read().strip()
        if raw.startswith("["):
            items = json.loads(raw)
        else:
            items = raw.splitlines()
        return [str(c).strip() for c in items if str(c).strip()]
    return [c.strip() for c in text.split(";")]


def default_guide_concepts(guide_text: str | None, concept_type: str) -> str:
    """Reference default: '' (unconditional) unless erasing art -> 'art'."""
    if guide_text is not None:
        return guide_text
    return "art" if concept_type == "art" else ""


def broadcast_guides(edit_concepts: list[str], guide_concepts: list[str]) -> list[str]:
    """A single guide concept is broadcast to every edit concept."""
    if len(guide_concepts) == 1:
        guide_concepts = guide_concepts * len(edit_concepts)
    if len(guide_concepts) != len(edit_concepts):
        raise ValueError(
            "The length of erase concepts and their corresponding guide "
            "concepts do not match. Separate them by ';' with equal sizes."
        )
    return guide_concepts


def expand_prompts(
    edit_concepts: list[str],
    guide_concepts: list[str],
    concept_type: str,
) -> tuple[list[str], list[str]]:
    """Append the five template variants per (edit, guide) pair."""
    templates = ART_TEMPLATES if concept_type == "art" else OBJECT_TEMPLATES
    edits = list(edit_concepts)
    guides = list(guide_concepts)
    for concept, guide in zip(edit_concepts, guide_concepts):
        edits.extend(t.format(concept) for t in templates)
        guides.extend(t.format(guide) for t in templates)
    return edits, guides


def resolve_edit_request(
    edit_text: str,
    guide_text: str | None,
    preserve_text: str | None,
    concept_type: str = "object",
    expand: bool = False,
) -> tuple[list[str], list[str], list[str]]:
    """Full CLI resolution: parse, default, broadcast, optionally expand."""
    edit_concepts = parse_concepts(edit_text)
    guide_concepts = parse_concepts(default_guide_concepts(guide_text, concept_type))
    guide_concepts = broadcast_guides(edit_concepts, guide_concepts)
    preserve_concepts = parse_concepts(preserve_text) if preserve_text else []
    if expand:
        edit_concepts, guide_concepts = expand_prompts(
            edit_concepts, guide_concepts, concept_type
        )
    return edit_concepts, guide_concepts, preserve_concepts
