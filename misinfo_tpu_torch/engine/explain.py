"""Explanation generation (C9, SURVEY.md §2.1).

Host copy of ``misinfo_tpu/engine/explain.py``, importable without JAX;
held to the original by tests/test_torch_host.py.

Two paths, same contract as the reference (misinfo_forensics.py:617-765):

* **LLM path** — builds the structured markdown prompt embedding every
  numeric signal (plus the vault cross-check block when discrepancy > 0.5)
  and calls Gemini (`gemini-2.5-flash`); any error class falls through to
  the rules.
* **Rule path** — deterministic cascade keyed on the reference's exact
  thresholds: vault>0.7 → deepfake>0.7 → ai>0.7 → misinfo>0.7 →
  clip<0.3 → generic.

The LLM call is strictly a host-side post-step; it never blocks the XLA
pipeline (explanations for a batch are generated after scores return).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from misinfo_tpu_torch.core.config import Thresholds
from misinfo_tpu_torch.utils.tracing import GLOBAL_TRACER

logger = logging.getLogger("misinfo_tpu_torch.explain")

try:
    import google.generativeai as _genai
    GEMINI_AVAILABLE = True
except ImportError:
    _genai = None
    GEMINI_AVAILABLE = False


def build_llm_prompt(all_scores: Dict, vault_matches: List[Dict],
                     th: Thresholds = Thresholds()) -> str:
    """Structured analyst prompt; sections/fields match the reference's
    template (misinfo_forensics.py:631-693) so downstream dashboards see
    the same report shape."""
    verdict_text = "FAKE" if all_scores.get("verdict", 0) == 1 else "REAL"
    confidence = float(all_scores.get("confidence", 0.0) or 0.0)

    prompt = f"""You are a senior misinformation forensics analyst writing a detailed but concise report for a dashboard.

    Write the response in Markdown with the exact section headers below, using the provided numeric signals verbatim where relevant.

    Rules:
    - Be specific: cite key numbers (probabilities/similarities) and explain what they imply.
    - Rank the top signals (strongest to weakest) and explain how they contributed.
    - If a modality is missing (text/image/video), explicitly note what was skipped and how that limits confidence.
    - Avoid generic advice; focus on evidence-based reasoning.
    - Keep it readable: 120-220 words total.

    Use this format:
    ### Verdict
    <1-2 sentences with verdict + confidence and the core reason>

    ### Key Evidence (ranked)
    - <bullet 1>
    - <bullet 2>
    - <bullet 3>

    ### Cross-Checks & Caveats
    - <1-2 bullets about vault/consistency or missing signals>

    ### Recommended Next Step
    <1 sentence: what the user should do to verify>

FORENSIC ANALYSIS SCORES:

1. Final Verdict & Confidence:
   - Verdict: {verdict_text}
   - Confidence Score: {confidence:.1%} (derived from softmax probabilities)
   - REAL Probability: {all_scores.get('real_probability', 0.0):.2%}
   - FAKE Probability: {all_scores.get('fake_probability', 0.0):.2%}

2. AI-Text & Propaganda Probability:
   - AI-Generated Score: {all_scores.get('ai_score', 0.0):.2%} (RoBERTa classifier, higher = more AI-like)
   - Propaganda/Misinfo Score: {all_scores.get('misinfo_score', 0.0):.2%} (trained on WELFake dataset)

3. Deepfake Visual Score:
   - Deepfake Probability: {all_scores.get('deepfake_score', 0.0):.2%} (EfficientNet on CIFAKE dataset)

4. Consistency (CLIP) & Vault Discrepancy:
    - Image-Text Consistency: {float(all_scores.get('clip_similarity', 0.0) or 0.0):.4f} (cosine similarity, -1 to 1)
    - Historical Database Match: {float(all_scores.get('vault_discrepancy', 0.0) or 0.0):.2%} (image found in archive)
"""

    if vault_matches and all_scores.get("vault_discrepancy", 0.0) > th.vault_prompt_gate:
        top = vault_matches[0]
        text_sim = float(all_scores.get("text_similarity", 0.0) or 0.0)
        prompt += f"""
5. Truth Vault Cross-Check:
   - Match Found: "{top['title']}"
   - Image Similarity: {top['similarity']:.1%}
   - Text Similarity Score: {text_sim:.2%} (CLIP text encoder comparison)
   - Published: {top.get('date', 'N/A')}
   - Context: Image reused from different story
"""

    prompt += ("\n\nTask: Produce the Markdown report using the structure above. "
               "Emphasize the strongest quantitative signals and any contradictions "
               "(e.g., high vault match but low text similarity, or strong text "
               "signal but weak visual signal).")
    return prompt


def rule_based_explanation(all_scores: Dict, vault_matches: List[Dict],
                           th: Thresholds = Thresholds()) -> str:
    """Deterministic fallback cascade (reference misinfo_forensics.py:742-765);
    thresholds and precedence preserved exactly."""
    verdict_text = "FAKE" if all_scores.get("verdict", 0) == 1 else "REAL"

    if all_scores.get("vault_discrepancy", 0.0) > th.explain_vault and vault_matches:
        return (f"This content is classified as {verdict_text}. "
                f"Our database found this image was previously published in a "
                f"different context (\"{vault_matches[0]['title']}\"), "
                f"suggesting potential misuse.")
    if all_scores.get("deepfake_score", 0.0) > th.explain_deepfake:
        return (f"This content is classified as {verdict_text}. "
                f"The image shows strong signs of digital manipulation "
                f"(deepfake probability: {all_scores['deepfake_score']:.1%}).")
    if all_scores.get("ai_score", 0.0) > th.explain_ai:
        return (f"This content is classified as {verdict_text}. "
                f"The text exhibits characteristics typical of AI-generated content.")
    if all_scores.get("misinfo_score", 0.0) > th.explain_misinfo:
        return (f"This content is classified as {verdict_text}. "
                f"The text uses language patterns commonly associated with "
                f"misinformation.")
    if all_scores.get("clip_similarity", 0.0) < th.explain_clip_low:
        return (f"This content is classified as {verdict_text}. "
                f"The image and caption show poor alignment, suggesting "
                f"potential mismatching.")
    return (f"This content is classified as {verdict_text} with "
            f"{all_scores.get('confidence', 0.0):.1%} confidence. "
            f"Multiple signals from text analysis, image forensics, and "
            f"database checks support this assessment.")


# Error-class → operator guidance, matching the reference's diagnostic
# branches (misinfo_forensics.py:725-740): auth and quota blips need
# DIFFERENT operator action, so they must be distinguishable in /metrics.
_ERROR_HINTS = {
    "auth": "check the GOOGLE_API_KEY (env or .env)",
    "quota": "API quota exceeded — wait for the window or raise the quota",
    "timeout": "Gemini API timeout — transient; retry or check egress",
    "empty": "Gemini returned an empty response",
    "other": "unclassified Gemini API error",
}


def classify_gemini_error(exc: BaseException) -> str:
    """Reference's substring classification (misinfo_forensics.py:727-736):
    'api key'/'authentication' → auth, 'quota'/'limit' → quota,
    'timeout' → timeout, else other."""
    msg = str(exc).lower()
    if "api key" in msg or "authentication" in msg:
        return "auth"
    if "quota" in msg or "limit" in msg:
        return "quota"
    if "timeout" in msg:
        return "timeout"
    return "other"


class Explainer:
    """Soft-fail explanation generator (error classes → rules, reference
    misinfo_forensics.py:725-740).

    Every LLM-path outcome is observable (VERDICT r2 #5): successes and
    each failure class feed per-class tracer counters —
    ``gemini_ok_count`` / ``gemini_error_{auth,quota,timeout,empty,other}_count``
    in ``/metrics`` — plus a structured warning log carrying the operator
    hint, so a bad key is distinguishable from a quota blip without
    reading fallback prose."""

    def __init__(self, api_key: Optional[str] = None,
                 model_name: str = "gemini-2.5-flash",
                 thresholds: Thresholds = Thresholds(), tracer=None):
        self.thresholds = thresholds
        self.available = False
        self._model = None
        self.tracer = tracer if tracer is not None else GLOBAL_TRACER
        self.last_error: Optional[Dict] = None
        if GEMINI_AVAILABLE and api_key:
            try:
                _genai.configure(api_key=api_key)
                self._model = _genai.GenerativeModel(model_name)
                self.available = True
            except Exception as e:
                self.available = False
                self._record_error(e, stage="configure")

    def _record_error(self, exc: Optional[BaseException], *,
                      cls: Optional[str] = None, stage: str = "generate"):
        cls = cls or classify_gemini_error(exc)
        hint = _ERROR_HINTS[cls]
        self.last_error = {"class": cls, "hint": hint,
                           "error": str(exc) if exc else "",
                           "stage": stage}
        # count-only: outcome counters must not seed the latency
        # reservoirs with fake 0-second events (Tracer.incr docstring)
        self.tracer.incr(f"gemini_error_{cls}_count")
        logger.warning("gemini %s failed [%s]: %s — %s "
                       "(falling back to rule-based explanation)",
                       stage, cls, exc if exc else "empty response", hint)

    def explain(self, all_scores: Dict, vault_matches: List[Dict]) -> str:
        if not self.available:
            return rule_based_explanation(all_scores, vault_matches, self.thresholds)
        try:
            prompt = build_llm_prompt(all_scores, vault_matches, self.thresholds)
            response = self._model.generate_content(prompt)
            text = getattr(response, "text", None)
            if text:
                self.tracer.incr("gemini_ok_count")
                return text.strip()
            # valid call, empty payload (reference :721-723)
            self._record_error(None, cls="empty")
        except Exception as e:
            self._record_error(e)
        return rule_based_explanation(all_scores, vault_matches, self.thresholds)
