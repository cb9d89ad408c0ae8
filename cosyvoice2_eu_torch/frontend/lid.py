"""Statistical FR/DE/EN language identification (character trigrams).

The reference detects per-sentence language with the lingua statistical
detector (reference: cosy_repo/cosyvoice/cli/frontend.py:297, falling back
to heuristics when lingua is absent).  This is the package's own equivalent:
a Cavnar–Trenkle out-of-place rank profile over character trigrams, with
profiles built at import time from embedded seed text, so short mixed-
language sentences (the cross-lingual mode's bread and butter) classify
robustly without any external model.

Strong orthographic signals (ß only exists in German; ç/œ only in French)
still short-circuit, mirroring the reference's contains_chinese-style
pre-checks.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict

# Seed text per language: everyday prose written for this module (spanning
# pronouns, function words, verb morphology — what trigram profiles key on).
_SEEDS = {
    "fr": (
        "bonjour tout le monde je voudrais vous parler de la journée que nous "
        "avons passée ensemble hier soir nous sommes allés au marché pour "
        "acheter des légumes du pain et du fromage ensuite nous avons préparé "
        "le dîner avec les enfants qui étaient très contents de nous aider "
        "c'est toujours un plaisir de cuisiner quand il fait beau dehors "
        "demain matin je dois aller travailler mais je pense déjà aux "
        "vacances que nous allons prendre cet été au bord de la mer il y aura "
        "du soleil et nous pourrons nager tous les jours les amis viendront "
        "nous voir et nous ferons de longues promenades sur la plage avant de "
        "rentrer à la maison pour manger quelque chose de bon voilà pourquoi "
        "j'aime cette saison elle me rappelle mon enfance dans le sud où mes "
        "parents avaient une petite maison près des montagnes"
    ),
    "de": (
        "guten morgen liebe leute ich möchte euch heute erzählen was wir "
        "gestern gemacht haben wir sind zusammen auf den markt gegangen um "
        "gemüse brot und käse zu kaufen danach haben wir mit den kindern das "
        "abendessen vorbereitet sie waren sehr glücklich dass sie helfen "
        "durften es macht immer freude zu kochen wenn das wetter schön ist "
        "morgen früh muss ich wieder arbeiten aber ich denke schon an den "
        "urlaub den wir im sommer am meer verbringen werden die sonne wird "
        "scheinen und wir können jeden tag schwimmen unsere freunde kommen "
        "uns besuchen und wir machen lange spaziergänge am strand bevor wir "
        "nach hause gehen um etwas gutes zu essen deshalb liebe ich diese "
        "jahreszeit sie erinnert mich an meine kindheit im süden wo meine "
        "eltern ein kleines haus in der nähe der berge hatten"
    ),
    "en": (
        "good morning everyone today i would like to tell you about the day "
        "we spent together yesterday evening we went to the market to buy "
        "vegetables bread and cheese then we prepared dinner with the "
        "children who were very happy to help us it is always a pleasure to "
        "cook when the weather is nice outside tomorrow morning i have to go "
        "to work but i am already thinking about the holidays we are going "
        "to take this summer by the sea the sun will shine and we will be "
        "able to swim every day our friends will come to visit us and we "
        "will take long walks on the beach before going home to eat "
        "something good that is why i love this season it reminds me of my "
        "childhood in the south where my parents had a small house near the "
        "mountains"
    ),
}

_PROFILE_SIZE = 400
_CLEAN = re.compile(r"[^a-zà-öø-ÿœßäöü'\s]+")

# orthography that pins a language outright — ONLY characters/contractions
# that essentially never appear in the other two languages (ß is German-only;
# ç/œ and the clitic contractions are French-only).  Circumflex/diaeresis
# vowels are NOT here: loanwords (Crêpes, naïve) occur freely in DE/EN text
# and must not pre-empt the trigram evidence.
_ONLY_DE = re.compile(r"ß")
_ONLY_FR = re.compile(r"[çœ]|c'est|j'ai|qu'il|qu'elle|n'est")


def _trigrams(text: str) -> Counter:
    text = _CLEAN.sub(" ", text.lower())
    text = re.sub(r"\s+", " ", f" {text.strip()} ")
    return Counter(text[i : i + 3] for i in range(max(len(text) - 2, 0)))


def _build_profile(text: str) -> Dict[str, int]:
    counts = _trigrams(text)
    ranked = [g for g, _ in counts.most_common(_PROFILE_SIZE)]
    return {g: i for i, g in enumerate(ranked)}


_PROFILES: Dict[str, Dict[str, int]] = {
    lang: _build_profile(seed) for lang, seed in _SEEDS.items()
}


def _distance(text_profile, lang_profile: Dict[str, int]) -> float:
    """Cavnar–Trenkle out-of-place distance, normalized per trigram."""
    max_oop = _PROFILE_SIZE
    total = 0
    for i, g in enumerate(text_profile):
        j = lang_profile.get(g)
        total += abs(i - j) if j is not None else max_oop
    return total / max(len(text_profile), 1)


def detect_language(text: str, default: str = "en") -> str:
    """FR/DE/EN id for one sentence (possibly very short)."""
    if _ONLY_DE.search(text):
        return "de"
    if _ONLY_FR.search(text.lower()):
        return "fr"
    counts = _trigrams(text)
    if sum(counts.values()) < 3:
        return default
    text_profile = [g for g, _ in counts.most_common(_PROFILE_SIZE)]
    scores = {
        lang: _distance(text_profile, prof) for lang, prof in _PROFILES.items()
    }
    ranked = sorted(scores.items(), key=lambda kv: kv[1])
    # no-evidence guard: gibberish scores near the max distance for every
    # language with no separation — fall back to the default
    if ranked[0][1] > 0.93 * _PROFILE_SIZE or \
            ranked[1][1] - ranked[0][1] < 0.01 * _PROFILE_SIZE:
        return default
    return ranked[0][0]
