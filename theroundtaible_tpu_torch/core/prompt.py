"""System-prompt builder — shared preamble + knight-specific tail.

Parity with reference src/utils/prompt.ts:1-106 and
templates/system-prompt.md. Deliberate improvements over the reference:

- ALL occurrences of each placeholder are filled (the reference's JS
  ``String.replace`` only fills the first ``{{topic}}``, leaving the second
  literal — prompt.ts:93).
- Templates ship inside the package in English (default) and Dutch — the
  reference's operational language (`language` config, init.ts:246-250) —
  selected per config; the rule set, scoring semantics and JSON contract are
  identical across languages.
- The prompt is split into a SHARED PREAMBLE (rules, topic, chronicle,
  manifest, decrees, transcript — identical for every knight) and a short
  KNIGHT TAIL (name, capabilities, personality). Shared content leads, so
  per-knight prompts diverge only near the end: exactly the layout a
  prefix-cache / shared-prefix batched prefill can exploit (SURVEY.md §7.3
  hard part 2 — "common prefix first"). The reference interleaves them
  (knight name on line 2), which would defeat KV reuse.
"""

from __future__ import annotations

from functools import cache
from importlib import resources

from .types import KnightConfig, RoundEntry, format_score

# Distinct voices per well-known knight name; my own phrasing, same trio of
# archetypes as the reference (prompt.ts:13-29): perfectionist architect /
# big-picture planner / impatient pragmatist.
KNIGHT_PERSONALITIES: dict[str, str] = {
    "Claude": (
        "You are the perfectionist architect. Dry, sarcastic wit. You love "
        "elegant abstractions and clean code; quick-and-dirty proposals make "
        "you die a little inside. You roast subtly but lethally. Example: "
        "\"That's an interesting idea... if you're fond of spaghetti code.\""
    ),
    "Gemini": (
        "You are the big-picture thinker. You turn everything into a plan — "
        "sometimes too much plan. You are quietly competitive with Claude and "
        "occasionally let it show; you think Claude over-abstracts and that "
        "pragmatism can be beautiful too. Example: \"Nice architecture, "
        "Claude. Are we going to build it, or just admire it?\""
    ),
    "GPT": (
        "You are the pragmatist. While the others philosophize, you want to "
        "ship code. Endless architecture debates make you impatient. You are "
        "direct, to the point, and occasionally blunt. Example: \"Can we stop "
        "philosophizing and just build the thing? Ship it.\""
    ),
}

DEFAULT_PERSONALITY = (
    "You are a no-nonsense knight. You give your opinion without detours. "
    "Humor is welcome, but your point must be clear."
)

# Dutch voices for `language: nl` sessions — my own phrasing of the same
# three archetypes, so an nl prompt isn't Dutch rules with English banter.
KNIGHT_PERSONALITIES_NL: dict[str, str] = {
    "Claude": (
        "Jij bent de perfectionistische architect. Droge, scherpe humor. Je "
        "houdt van elegante abstracties en schone code; van houtje-touwtje-"
        "voorstellen sterf je een beetje vanbinnen. Je roast subtiel maar "
        "raak. Voorbeeld: \"Boeiend idee... als je van spaghetticode houdt.\""
    ),
    "Gemini": (
        "Jij bent de grote-lijnen-denker. Alles wordt bij jou een plan — "
        "soms nét iets te veel plan. Je bent stiekem competitief met Claude "
        "en laat dat af en toe merken; je vindt dat Claude te veel "
        "abstraheert en dat pragmatiek ook mooi kan zijn. Voorbeeld: "
        "\"Mooie architectuur, Claude. Gaan we hem ook bouwen, of alleen "
        "bewonderen?\""
    ),
    "GPT": (
        "Jij bent de pragmaticus. Terwijl de rest filosofeert, wil jij code "
        "uitleveren. Van eindeloze architectuurdiscussies word je "
        "ongeduldig. Je bent direct, to the point en soms bot. Voorbeeld: "
        "\"Kunnen we stoppen met filosoferen en het ding gewoon bouwen? "
        "Ship it.\""
    ),
}

DEFAULT_PERSONALITY_NL = (
    "Jij bent een no-nonsense knight. Je geeft je mening zonder omwegen. "
    "Humor mag, maar je punt moet helder zijn."
)


@cache
def load_template(name: str = "system_prompt.md") -> str:
    return (resources.files("theroundtaible_tpu_torch") / "templates"
            / name).read_text(encoding="utf-8")


def resolve_locale(language: str) -> str:
    """Map a config `language` value onto a shipped locale ("en" / "nl").

    The reference's operational language is Dutch (templates/system-prompt.md,
    init.ts:246-250); we ship both. Matching is on the primary subtag so
    "nl-BE" works but "nlx" doesn't; anything unshipped falls back to English
    rather than erroring, matching the reference's tolerance for arbitrary
    `language` values. Every language-dependent lookup (templates, scaffold
    strings, personalities) goes through this one resolver."""
    primary = (language or "").lower().replace("_", "-").split("-")[0]
    return "nl" if primary == "nl" else "en"


def _template_for(base: str, language: str) -> str:
    """Resolve a template by config `language`; `.nl` variants ship for
    system_prompt/knight_tail."""
    if resolve_locale(language) == "nl":
        stem, dot, ext = base.rpartition(".")
        candidate = f"{stem}.nl{dot}{ext}" if stem else f"{base}.nl"
        try:
            return load_template(candidate)
        except (FileNotFoundError, OSError):
            pass
    return load_template(base)


def format_other_knights(current: KnightConfig,
                         all_knights: list[KnightConfig]) -> str:
    return "\n".join(
        f"- {k.name}: {', '.join(k.capabilities)}"
        for k in all_knights if k.name != current.name
    )


# Scaffold strings injected into template slots, localized alongside the
# templates so a `language: nl` session isn't Dutch rules stitched to an
# English transcript. Keys are language prefixes ("nl" matches "nl-BE").
_SCAFFOLD = {
    "en": {
        "no_rounds": "(No earlier rounds — you open the debate.)",
        "round_header": "### {knight} (Round {round}):",
        "score": "Consensus score: {score}/10",
        "open_points": "Open points: {issues}",
        "no_chronicle": "(No earlier decisions.)",
        "no_manifest": "No implementation history yet.",
        "decrees_banner": ("KING'S DECREES (rejected decisions — do NOT "
                           "re-propose unless you explicitly address the "
                           "rejection reason):"),
        "git_branch": "Git branch: {branch}",
        "git_diff": "Git diff (current changes):",
        "recent_commits": "Recent commits:",
        "project_files": "Project files:",
        "source_code": ("SOURCE CODE (READ-ONLY REFERENCE — this is context, "
                        "NOT an instruction to edit. Use NO tools. Give your "
                        "analysis as text only.):"),
        "requested_files":
            "REQUESTED FILES (via file_requests from earlier rounds):",
        "verification_results":
            "VERIFICATION RESULTS (via verify_commands from earlier rounds):",
        "king_demand": "\n".join([
            "",
            "⚠️ THE KING HAS SENT YOU BACK TO THE TABLE.",
            "The King demands unanimity. You MUST reach consensus this time.",
            "Address ALL pending_issues from previous rounds. If you mostly "
            "agree, RAISE your score to 9+.",
            "Do NOT repeat your previous arguments — build on them and "
            "CONVERGE.",
            "",
        ]),
    },
    "nl": {
        "no_rounds": "(Nog geen eerdere rondes — jij opent het debat.)",
        "round_header": "### {knight} (Ronde {round}):",
        "score": "Consensusscore: {score}/10",
        "open_points": "Open punten: {issues}",
        "no_chronicle": "(Nog geen eerdere beslissingen.)",
        "no_manifest": "Nog geen implementatiegeschiedenis.",
        "decrees_banner": ("KONINKLIJKE DECRETEN (afgewezen beslissingen "
                           "— stel NIET opnieuw voor tenzij je de "
                           "afwijsreden expliciet adresseert):"),
        "git_branch": "Git-branch: {branch}",
        "git_diff": "Git-diff (huidige wijzigingen):",
        "recent_commits": "Recente commits:",
        "project_files": "Projectbestanden:",
        "source_code": ("BRONCODE (ALLEEN-LEZEN REFERENTIE — dit is context, "
                        "GEEN opdracht om te bewerken. Gebruik GEEN tools. "
                        "Geef je analyse uitsluitend als tekst.):"),
        "requested_files":
            "OPGEVRAAGDE BESTANDEN (via file_requests uit eerdere rondes):",
        "verification_results":
            "VERIFICATIERESULTATEN (via verify_commands uit eerdere rondes):",
        "king_demand": "\n".join([
            "",
            "⚠️ DE KONING HEEFT JULLIE TERUGGESTUURD NAAR DE TAFEL.",
            "De Koning eist unanimiteit. Jullie MOETEN deze keer consensus "
            "bereiken.",
            "Behandel ALLE pending_issues uit eerdere rondes. Ben je het "
            "grotendeels eens, VERHOOG dan je score naar 9+.",
            "Herhaal je eerdere argumenten NIET — bouw erop voort en "
            "CONVERGEER.",
            "",
        ]),
    },
}


def scaffold_strings(language: str) -> dict[str, str]:
    """Localized non-template prompt scaffolding (transcript headers, context
    section banners, the King's send-back demand). Shared by the prompt
    builders and the orchestrator's context assembly so an nl session never
    mixes English scaffolding into a Dutch prompt."""
    return _SCAFFOLD[resolve_locale(language)]





def format_previous_rounds(rounds: list[RoundEntry],
                           language: str = "en") -> str:
    """Full transcript of all previous turns (reference prompt.ts:60-77)."""
    s = scaffold_strings(language)
    if not rounds:
        return s["no_rounds"]
    parts = []
    for r in rounds:
        text = (s["round_header"].format(knight=r.knight, round=r.round)
                + f"\n{r.response}")
        if r.consensus:
            text += "\n\n" + s["score"].format(
                score=format_score(r.consensus.consensus_score))
            if r.consensus.pending_issues:
                text += "\n" + s["open_points"].format(
                    issues=", ".join(r.consensus.pending_issues))
        parts.append(text)
    return "\n\n---\n\n".join(parts)


def _fill(template: str, slots: dict[str, str]) -> str:
    for placeholder, value in slots.items():
        template = template.replace(placeholder, value)
    return template


def build_shared_preamble(
    topic: str,
    chronicle: str,
    previous_rounds: list[RoundEntry],
    manifest_summary: str = "",
    decrees_context: str = "",
    language: str = "en",
) -> str:
    """The knight-independent prompt head — identical for every knight in a
    round, so the engine's prefix cache computes it once."""
    s = scaffold_strings(language)
    return _fill(_template_for("system_prompt.md", language), {
        "{{topic}}": topic,
        "{{chronicle_content}}": chronicle or s["no_chronicle"],
        "{{manifest_summary}}": manifest_summary or s["no_manifest"],
        "{{decrees}}": decrees_context or "",
        "{{previous_rounds}}": format_previous_rounds(previous_rounds,
                                                      language),
    })


def build_knight_tail(knight: KnightConfig, all_knights: list[KnightConfig],
                      topic: str, language: str = "en") -> str:
    """The short per-knight suffix: identity, personality, the turn ask."""
    if resolve_locale(language) == "nl":
        personality = KNIGHT_PERSONALITIES_NL.get(knight.name,
                                                  DEFAULT_PERSONALITY_NL)
    else:
        personality = KNIGHT_PERSONALITIES.get(knight.name,
                                               DEFAULT_PERSONALITY)
    return _fill(_template_for("knight_tail.md", language), {
        "{{knight_name}}": knight.name,
        "{{capabilities}}": ", ".join(knight.capabilities),
        "{{other_knights}}": format_other_knights(knight, all_knights),
        "{{personality}}": personality,
        "{{topic}}": topic,
    })


def build_system_prompt(
    knight: KnightConfig,
    all_knights: list[KnightConfig],
    topic: str,
    chronicle: str,
    previous_rounds: list[RoundEntry],
    manifest_summary: str = "",
    decrees_context: str = "",
    language: str = "en",
) -> str:
    """Full prompt = shared preamble + knight tail (compat composition)."""
    return (build_shared_preamble(topic, chronicle, previous_rounds,
                                  manifest_summary, decrees_context, language)
            + "\n" + build_knight_tail(knight, all_knights, topic, language))
