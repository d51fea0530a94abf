"""Synonym resource for the METEOR synonym matching stage.

The port's own copy of gpt2_vision_language_tpu/eval/synonyms.py (stdlib
only; NLTK's WordNet is read when it is importable and its corpus is
installed).

The Java METEOR-1.5 (the scorer behind the reference's reported numbers,
README.md:194-196) matches two unigrams in its synonym stage when they
share a WordNet synset. WordNet's data files cannot be fetched on an
air-gapped pod, so the resolver is pluggable, in priority order:

  1. `$METEOR_SYNONYMS` — path to a text file, one synonym group per line
     (whitespace- or comma-separated words). Lets a deployment drop in a
     full WordNet-derived table.
  2. NLTK WordNet, when its corpus data happens to be installed
     (`wordnet_groups()` exports it to the file format of (1)).
  3. A built-in compact table of caption-domain synonym groups (derived
     from common COCO caption vocabulary), so the synonym stage is always
     exercised; scores with the builtin table are a lower bound on
     full-WordNet METEOR, a much tighter one than skipping the stage.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Set

# Compact caption-domain synonym groups (WordNet-style synsets restricted
# to vocabulary frequent in COCO captions).
BUILTIN_GROUPS: List[List[str]] = [
    ["man", "guy", "gentleman", "male"],
    ["woman", "lady", "female"],
    ["person", "individual", "human"],
    ["people", "persons", "folks", "crowd"],
    ["child", "kid", "youngster"],
    ["boy", "lad"],
    ["girl", "lass"],
    ["picture", "photo", "photograph", "image", "shot"],
    ["bicycle", "bike", "cycle"],
    ["motorcycle", "motorbike"],
    ["car", "automobile", "auto", "vehicle"],
    ["bus", "coach"],
    ["airplane", "plane", "aircraft", "jet"],
    ["boat", "ship", "vessel"],
    ["train", "locomotive"],
    ["taxi", "cab"],
    ["couch", "sofa"],
    ["television", "tv"],
    ["cellphone", "phone", "telephone", "mobile"],
    ["laptop", "computer", "notebook"],
    ["refrigerator", "fridge"],
    ["sidewalk", "pavement", "walkway"],
    ["street", "road", "roadway"],
    ["store", "shop", "market"],
    ["house", "home", "residence"],
    ["building", "structure"],
    ["kitchen", "cookery"],
    ["bathroom", "restroom", "washroom", "toilet", "lavatory"],
    ["sea", "ocean"],
    ["beach", "shore", "seashore", "seaside"],
    ["forest", "woods", "woodland"],
    ["mountain", "mount", "peak"],
    ["field", "meadow", "pasture"],
    ["grass", "lawn", "turf"],
    ["rock", "stone", "boulder"],
    ["dog", "puppy", "canine", "pup"],
    ["cat", "kitten", "feline", "kitty"],
    ["bird", "fowl"],
    ["cow", "cattle", "bovine"],
    ["horse", "pony", "equine"],
    ["sheep", "lamb"],
    ["rabbit", "bunny", "hare"],
    ["big", "large", "huge", "enormous", "giant"],
    ["small", "little", "tiny", "miniature"],
    ["tall", "high"],
    ["fast", "quick", "rapid", "speedy"],
    ["slow", "sluggish"],
    ["happy", "glad", "joyful", "cheerful"],
    ["sad", "unhappy", "gloomy"],
    ["pretty", "beautiful", "lovely", "attractive", "gorgeous"],
    ["old", "elderly", "aged", "ancient"],
    ["young", "youthful"],
    ["close", "near", "nearby"],
    ["begin", "start", "commence"],
    ["end", "finish", "conclude"],
    ["eat", "eating", "dine", "dining", "consume", "consuming"],
    ["drink", "drinking", "sip", "sipping"],
    ["walk", "walking", "stroll", "strolling"],
    ["run", "running", "jog", "jogging", "sprint", "sprinting"],
    ["jump", "jumping", "leap", "leaping"],
    ["ride", "riding"],
    ["carry", "carrying", "hold", "holding"],
    ["look", "looking", "watch", "watching", "view", "viewing"],
    ["talk", "talking", "speak", "speaking", "chat", "chatting"],
    ["play", "playing"],
    ["sit", "sitting", "seated"],
    ["stand", "standing"],
    ["sleep", "sleeping", "nap", "napping"],
    ["smile", "smiling", "grin", "grinning"],
    ["throw", "throwing", "toss", "tossing"],
    ["catch", "catching", "grab", "grabbing"],
    ["cut", "cutting", "slice", "slicing"],
    ["cook", "cooking", "prepare", "preparing"],
    ["wear", "wearing", "dressed"],
    ["jacket", "coat"],
    ["pants", "trousers"],
    ["hat", "cap"],
    ["shoes", "footwear", "sneakers"],
    ["bag", "sack", "purse", "handbag"],
    ["baggage", "luggage", "suitcase"],
    ["plate", "dish"],
    ["cup", "mug"],
    ["meal", "dinner", "supper"],
    ["food", "meals", "cuisine"],
    ["sandwich", "sub", "hoagie"],
    ["pizza", "pie"],
    ["soda", "pop", "cola"],
    ["desk", "table"],
    ["chair", "seat"],
    ["trash", "garbage", "rubbish", "waste"],
    ["gift", "present"],
    ["ball", "sphere"],
    ["bat", "club"],
    ["kid", "goat"],
    ["group", "bunch", "cluster", "gathering"],
    ["pair", "couple", "duo", "two"],
    ["many", "several", "numerous"],
    ["on", "atop", "upon"],
    ["beside", "alongside", "next"],
    ["under", "beneath", "below", "underneath"],
    ["above", "over"],
]


def parse_groups(lines: Iterable[str]) -> Dict[str, Set[int]]:
    """Word -> set of group ids, from one-group-per-line text."""
    table: Dict[str, Set[int]] = {}
    gid = 0
    for line in lines:
        words = [w for w in line.replace(",", " ").lower().split() if w]
        if len(words) < 2:
            continue
        for w in words:
            table.setdefault(w, set()).add(gid)
        gid += 1
    return table


def _builtin_table() -> Dict[str, Set[int]]:
    return parse_groups(" ".join(g) for g in BUILTIN_GROUPS)


def wordnet_groups() -> List[List[str]]:
    """Export WordNet noun/verb/adj synsets as synonym groups (requires the
    NLTK wordnet corpus; raises LookupError when absent)."""
    from nltk.corpus import wordnet as wn

    groups = []
    for syn in wn.all_synsets():
        lemmas = sorted(
            {l.name().lower() for l in syn.lemmas() if "_" not in l.name()}
        )
        if len(lemmas) >= 2:
            groups.append(lemmas)
    return groups


def resolve_synonym_table(
    path: str | None = None,
) -> tuple[Dict[str, Set[int]], str]:
    """Resolve the synonym table per the module docstring priority.

    Returns (table, provenance) where provenance is one of
    ``file:<path>`` / ``nltk-wordnet`` / ``builtin`` — METEOR scores are
    only comparable across machines when the provenance matches, so
    callers surface it next to the scores (eval/caption_eval.py logs it)."""
    path = path or os.environ.get("METEOR_SYNONYMS")
    if path:
        # an explicitly configured table must not silently degrade to the
        # builtin fallback — that would change METEOR scores with no signal
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"METEOR_SYNONYMS table not found: {path!r}"
            )
        with open(path, encoding="utf-8") as f:
            return parse_groups(f), f"file:{path}"
    try:
        return (
            parse_groups(" ".join(g) for g in wordnet_groups()),
            "nltk-wordnet",
        )
    except Exception:
        return _builtin_table(), "builtin"


def load_synonym_table(path: str | None = None) -> Dict[str, Set[int]]:
    return resolve_synonym_table(path)[0]


def synonym_match(w1: str, w2: str, table: Dict[str, Set[int]]) -> bool:
    """True when the two words share a synonym group (METEOR's shared-synset
    rule)."""
    g1 = table.get(w1)
    if not g1:
        return False
    g2 = table.get(w2)
    return bool(g2) and not g1.isdisjoint(g2)
