"""Math answer verification (local, sympy-based): a copy of
``areal_tpu/rewards/math_verify.py``, which the port may not import.

It is the counterpart of ``realhf/impl/dataset/math_parser.py`` (875
LoC, latex2sympy-based), re-implemented dependency-light and kept
BEHAVIOR-COMPATIBLE — reward disagreement with the reference is
training-signal corruption, so the pipeline mirrors its semantics
(``process_results`` -> ``extract_answer`` -> ``strip_string`` ->
``math_equal``):

- extraction (``math_parser.py:362``): "final answer is $X$. I hope",
  ``\\boxed{...}``, "the/final answer is"; the GENERATED side gets NO
  last-number fallback (``process_results`` passes use_last_number=False,
  ``math_parser.py:765``) — unboxed chatter scores 0, exactly like the
  reference; the SOLUTION side does fall back to its last number.
- normalization (``strip_string``, ``math_parser.py:221``): units/\\text
  suffixes, degree marks, currency, percent signs, word numbers,
  ``x=``-prefix dropping, ``\\sqrt3``/``\\frac12``/``a/b`` shorthand
  repair, trailing-zero and leading-dot repair, i/j imaginary, infinity
  spellings, \\emptyset, pmatrix/bmatrix/array unification.
- equality (``math_equal``, ``math_parser.py:497``): case-insensitive
  string match; A-E choice cleaning; numeric equality at rel_tol=1e-4
  against [t/100, t, t*100] (the reference's include_percentage is
  unconditional); bracket-insensitive compare; ordered elementwise
  tuples/intervals; pmatrix elementwise; one-sided ``x=5`` unwrapping and
  two-sided equation equivalence (difference, up to sign); sympy
  symbolic/numeric fallback.

Deliberate divergences (documented; see tests/data/math_parity.json):
- ``{a, b}`` set answers compare UNORDERED here (mathematically correct;
  the reference's brace-stripped string/symbolic path is order-sensitive
  except when sympify happens to build a set).
- latex2sympy grammar coverage (r4): \\operatorname, named trig/log/exp
  functions, \\log bases, \\binom, \\left/\\right + styling macros,
  single-pair |x|, and answer-position \\sum/\\int forms translate;
  exotic constructs beyond that still fall to the remote sandbox
  verifier in production.
"""

import re
from typing import List, Optional

# ---------------------------------------------------------------------- #
# extraction
# ---------------------------------------------------------------------- #


def extract_boxed(text: str) -> Optional[str]:
    r"""Content of the last ``\boxed{...}`` with balanced braces."""
    idx = text.rfind("\\boxed")
    if idx < 0:
        return None
    i = text.find("{", idx)
    if i < 0:
        # reference also accepts `\boxed 5$...`: bare token up to `$`
        tail = text[idx + len("\\boxed") :]
        tok = tail.split("$")[0].strip()
        return tok or None
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[i + 1 : j]
    return None


_NUM_RE = re.compile(r"-?\d*\.?\d+")


def extract_answer(text: str, use_last_number: bool = True) -> Optional[str]:
    """Mirror of the reference's ``extract_answer(..., "math")``
    (``math_parser.py:362``). The generated side must call with
    ``use_last_number=False`` (``process_results`` semantics)."""
    if "final answer is $" in text and "$. I hope" in text:
        ans = text.split("final answer is $", 1)[1].split("$. I hope", 1)[0]
        # models often box the answer INSIDE the hope-pattern span; unwrap
        # so downstream equality sees the payload, not the \boxed marker
        if "\\boxed" in ans:
            boxed = extract_boxed(ans)
            if boxed is not None:
                ans = boxed
        return _strip_answer_token(ans.strip())
    boxed = extract_boxed(text)
    if boxed is not None:
        return _strip_answer_token(boxed)
    m = re.search(r"(?:he|final) answer is[:\s]*([^\n]*)", text)
    if m:
        return _strip_answer_token(m.group(1).strip())
    if use_last_number:
        nums = _NUM_RE.findall(text.replace(",", ""))
        return _strip_answer_token(nums[-1]) if nums else None
    return None


def _strip_answer_token(pred: str) -> str:
    pred = re.sub(r"\n\s*", "", pred)
    pred = pred.lstrip(":")
    pred = pred.rstrip(".").rstrip("/")
    return pred.strip().strip("$")


# ---------------------------------------------------------------------- #
# normalization (mirror of strip_string)
# ---------------------------------------------------------------------- #

# compact working set of the reference's MathQA unit_texts list
_UNIT_WORDS = (
    "degrees?|mph|kmph|k?m|cm|mm|ft|feet|inch(?:es)?|miles?|meters?|"
    "dollars?|cents?|hours?|minutes?|seconds?|km\\s*square|sq\\s*m|"
    "square\\s*units?|units?|points?|kg|grams?|gm|g|litres?|liters?|"
    "per\\s*hour|p\\.?\\s*m|a\\.?\\s*m"
)
_UNIT_RE = re.compile(r"(^|\W)(?:" + _UNIT_WORDS + r")($|\W)")

_WORD_NUMS = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
    "seventy": 70, "eighty": 80, "ninety": 90,
}


def _word_number(s: str) -> str:
    """Tiny stand-in for word2number: single words and hyphen compounds."""
    t = s.strip().lower()
    if t in _WORD_NUMS:
        return str(_WORD_NUMS[t])
    m = re.fullmatch(r"([a-z]+)-([a-z]+)", t)
    if m and m.group(1) in _WORD_NUMS and m.group(2) in _WORD_NUMS:
        tens, ones = _WORD_NUMS[m.group(1)], _WORD_NUMS[m.group(2)]
        if tens % 10 == 0 and ones < 10:
            return str(tens + ones)
    return s


def _fix_fracs(s: str) -> str:
    r"""``\frac12`` / ``\frac1{72}`` -> braced form (math_parser.py:159)."""
    parts = s.split("\\frac")
    out = parts[0]
    for sub in parts[1:]:
        out += "\\frac"
        if sub.startswith("{") or len(sub) < 2:
            out += sub
        else:
            a, b, rest = sub[0], sub[1], sub[2:]
            if b != "{":
                out += "{" + a + "}{" + b + "}" + rest
            else:
                out += "{" + a + "}" + b + rest
    return out


def _fix_a_slash_b(s: str) -> str:
    """Bare ``a/b`` with integer a, b -> ``\\frac{a}{b}``."""
    m = re.fullmatch(r"(-?\d+)/(-?\d+)", s)
    return f"\\frac{{{m.group(1)}}}{{{m.group(2)}}}" if m else s


def _normalize(s: str) -> str:
    s = str(s).strip().replace("\n", "")
    s = s.rstrip(".")
    s = s.replace("\\!", "")
    # matrices unify to pmatrix
    s = re.sub(r"\\begin\{array\}\{[^{}]*\}", r"\\begin{pmatrix}", s)
    s = s.replace("\\end{array}", "\\end{pmatrix}").replace(
        "bmatrix", "pmatrix"
    )
    s = s.replace("\\dfrac", "\\frac").replace("\\tfrac", "\\frac")
    s = (
        s.replace("\\neq", "\\ne").replace("\\leq", "\\le")
        .replace("\\geq", "\\ge")
    )
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\{", "{").replace("\\}", "}")
    # unit-ish trailing \text{...} vanishes; remaining \text{x} unwraps
    s2 = re.sub(r"\\text\{.*?\}$", "", s).strip()
    if s2 != "" and s2 != s:
        s = s2
    s = re.sub(r"\\(?:text|textbf|mathrm|mbox)\{(.*?)\}", r"\1", s)
    for _ in range(2):
        s2 = _UNIT_RE.sub(r"\1\2", s)
        if s2 != "":
            s = s2
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\(", "").replace("\\)", "")
    s = _word_number(s)
    for key in ("x=", "y=", "z=", "x\\in", "y\\in", "z\\in",
                "x\\to", "y\\to", "z\\to"):
        s = s.replace(key, "")
    s = s.replace("\\emptyset", "{}")
    s = s.replace("(-\\infty,\\infty)", "\\mathbb{R}")
    s = s.replace("\\%", "").replace("%", "")
    s = s.replace(" .", " 0.").replace("{.", "{0.")
    if (
        len(s) > 1 and s[0] in "({[" and s[-1] in ")}]"
        and s[1:-1].isalnum()
    ):
        s = s[1:-1]
    s = s.replace("infinity", "\\infty")
    if "\\infty" not in s:
        s = s.replace("inf", "\\infty")
    s = s.replace("and", "").replace("\\mathbf", "")
    if "j" in s and "i" not in s:
        s = s.replace("j", "i")
    s = re.sub(r"(\d+)\.0*([^\d])", r"\1\2", s)
    s = re.sub(r"(\d+)\.0*$", r"\1", s)
    if not s:
        return s
    if s[0] == ".":
        s = "0" + s
    # "k = 5" -> "5" when the lhs is short (variable assignment)
    if len(s.split("=")) == 2 and len(s.split("=")[0].strip()) <= 2:
        s = s.split("=")[1]
    s = re.sub(r"\\sqrt(\w+)", r"\\sqrt{\1}", s)
    s = s.replace(" ", "")
    s = _fix_fracs(s)
    s = _fix_a_slash_b(s)
    return s


# ---------------------------------------------------------------------- #
# LaTeX -> python expression (numeric/sympy layer)
# ---------------------------------------------------------------------- #


def _latex_to_expr(s: str) -> str:
    """Targeted LaTeX -> python-expression rewrites (the working set of
    ``math_parser.py``'s latex2sympy usage, without the vendored parser;
    extended r4 toward latex2sympy's grammar: \\operatorname, named
    functions, \\log bases, \\binom, |x|, \\sum and \\int forms)."""
    s = _normalize(s)
    # delimiter/styling macros latex2sympy ignores
    s = (
        s.replace("\\left", "").replace("\\right", "")
        .replace("\\dfrac", "\\frac").replace("\\tfrac", "\\frac")
        .replace("\\limits", "").replace("\\displaystyle", "")
        .replace("\\,", "").replace("\\!", "").replace("\\;", "")
    )
    # \operatorname{f} -> f (latex2sympy treats it as a plain function name)
    s = re.sub(r"\\operatorname\*?\{([A-Za-z]+)\}", r"\1", s)
    # mixed numbers: 1\frac{1}{2} -> (1+(1)/(2))
    s = re.sub(
        r"(?<![\w}])(\d+)\\frac\{([^{}]+)\}\{([^{}]+)\}",
        r"(\1+(\2)/(\3))", s,
    )
    # roots FIRST: \frac's brace-free-argument loop below must see
    # sqrt(...) not \sqrt{...}, or \frac{\sqrt{3}}{2} never translates
    s = re.sub(r"\\sqrt\[([^\]]+)\]\{([^{}]*)\}", r"((\2)**(1/(\1)))", s)
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s)
    s = re.sub(r"\\sqrt(\d+)", r"sqrt(\1)", s)
    # \frac{a}{b} -> ((a)/(b)), innermost-first for nesting
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"\\frac\{([^{}]*)\}\{([^{}]*)\}", r"((\1)/(\2))", s)
    s = (
        s.replace("\\pi", "pi")
        .replace("\\cdot", "*")
        .replace("\\times", "*")
        .replace("\\div", "/")
        .replace("\\infty", "oo")
    )
    # \binom{n}{k} -> binomial(n, k)
    s = re.sub(r"\\binom\{([^{}]*)\}\{([^{}]*)\}", r"binomial(\1, \2)", s)
    # a \mod b / a \pmod{b} (mod_test grammar): unbrace the \pmod argument,
    # then rewrite to python's %, whose MULTIPLICATIVE precedence matches
    # latex2sympy's mp-level mod rule ('3 + 7 \mod 4' == 3 + Mod(7,4), not
    # Mod(10, 4)). Unambiguous: _normalize already stripped literal '%'
    # (percent signs) from the answer text.
    s = re.sub(r"\\([pb]?)mod\{([^{}]*)\}", r"\\\1mod(\2)", s)
    s = re.sub(r"\\[pb]?mod(?![A-Za-z])", "%", s)
    # logs: \log_{b} x / \log_b x -> base-b; \log -> base 10 (latex2sympy's
    # convention); \ln -> natural
    s = re.sub(
        r"\\log_\{?(\w+)\}?\s*\(?\{?([\w.]+)\}?\)?",
        r"(log(\2)/log(\1))", s,
    )
    s = s.replace("\\ln", "log")
    s = re.sub(r"\\log\b", "log10", s)
    # named functions: \sin x -> sin(x) handled by implicit application
    s = re.sub(
        r"\\(sin|cos|tan|cot|sec|csc|arcsin|arccos|arctan|sinh|cosh|tanh|"
        r"exp|min|max|gcd|lcm)\b",
        r"\1", s,
    )
    # floor/ceiling delimiters (latex2sympy floor_test/ceil_test grammar).
    # AFTER every inner-command rewrite (\frac, \log, \sin, \mod, …) so the
    # argument is already plain-expression text; non-greedy with a
    # no-inner-opener guard, innermost-first for nesting — the old
    # ``[^\\]*`` match could not cross a backslash and left
    # ``\lfloor \log_2 8 \rfloor``-style answers untranslated (ADVICE r5 #2)
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"\\lfloor((?:(?!\\lfloor).)*?)\\rfloor", r"floor(\1)", s)
        s = re.sub(r"\\lceil((?:(?!\\lceil).)*?)\\rceil", r"ceiling(\1)", s)
    # sums / integrals as ANSWERS (rare but latex2sympy-grammar): the rest
    # of the string is the summand/integrand. LITERAL bounds only, sum span
    # capped — a model-controlled \sum_{i=1}^{10^9} (or symbolic bounds)
    # must not hand sympy unbounded work inside the reward worker (the
    # same DoS class _degenerate guards for powers).
    def _sum_repl(m):
        var, lo, hi, body = m.groups()
        try:
            span = float(hi) - float(lo)
        except ValueError:
            return m.group(0)  # non-literal bounds: leave untranslated
        if not 0 <= span <= 500:
            return m.group(0)
        return f"Sum({body}, ({var}, {lo}, {hi}))"

    s = re.sub(
        r"\\sum_\{(\w+)=([^{}]+)\}\^\{([^{}]+)\}\s*(.+)", _sum_repl, s
    )

    def _int_repl(m):
        lo, hi, body, var = m.groups()
        for b in (lo, hi):
            if not re.fullmatch(r"-?\d+(\.\d+)?|-?\\?pi|oo", b.strip()):
                return m.group(0)  # non-literal bounds: leave untranslated
        return f"Integral({body}, ({var}, {lo}, {hi}))"

    s = re.sub(
        r"\\int_\{?([^{}^]+)\}?\^\{?([^{}]+)\}?\s*(.+?)\\?d([a-z])\s*$",
        _int_repl, s,
    )
    # |x| -> Abs(x) when exactly one pair (brace-stripped: `|{-3}|`)
    if s.count("|") == 2:
        s = re.sub(
            r"\|([^|]*)\|",
            lambda m: f"Abs({m.group(1).replace('{', '(').replace('}', ')')})",
            s,
        )
    # exponents: ^{...} -> **(...); ^x -> **x
    s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
    s = s.replace("^", "**")
    # thousands separators only in properly-grouped numbers ('1,234' yes;
    # '1,2' is a two-part answer, not twelve)
    if re.fullmatch(r"-?\d{1,3}(?:,\d{3})+(?:\.\d+)?", s):
        s = s.replace(",", "")
    return s


def _parse_digits(s: str) -> Optional[float]:
    """float("...") with thousands separators removed and a trailing-%
    -> /100 (``parse_digits``, math_parser.py:445)."""
    t = str(s).replace(",", "")
    try:
        return float(t)
    except ValueError:
        if t.endswith("%"):
            t = t[:-1].rstrip("\\")
            try:
                return float(t) / 100.0
            except ValueError:
                pass
    return None


def _to_number(s: str) -> Optional[float]:
    """Numeric value of an answer via the LaTeX translation + sympy evalf
    (covers fractions, roots, pi, mixed numbers, scientific notation)."""
    direct = _parse_digits(s)
    if direct is not None:
        return direct
    expr = _latex_to_expr(s)
    if expr == "":
        return None
    try:
        return float(expr)
    except ValueError:
        pass
    if not re.fullmatch(r"[\d\s\.\+\-\*/\(\)eE]*|.*(?:sqrt|pi|oo).*", expr):
        return None
    if _degenerate(expr):
        return None
    try:
        import sympy

        val = sympy.sympify(expr, rational=False).evalf()
        if val.is_real is False or val.has(sympy.zoo, sympy.nan):
            return None
        return float(val)
    except Exception:  # noqa: BLE001 — unparseable => no numeric value
        return None


def _degenerate(expr: str) -> bool:
    """Model-controlled input: refuse expressions sympy would eagerly blow
    up on (2**999999999 stalls/OOMs the reward worker)."""
    return len(expr) > 128 or bool(re.search(r"\*\*\s*\(?\s*-?\d{5,}", expr))


# ---------------------------------------------------------------------- #
# equality (mirror of math_equal)
# ---------------------------------------------------------------------- #


def _choice_clean(pred: str) -> str:
    """``choice_answer_clean`` (math_parser.py:466): last standalone A-E."""
    p = pred.strip("\n").rstrip(".").rstrip("/").strip(" ").lstrip(":")
    hits = re.findall(r"\b(A|B|C|D|E)\b", p.upper())
    out = hits[-1] if hits else p.strip().strip(".")
    return out.rstrip(".").rstrip("/")


def _numeric_candidates_equal(fg: float, ft: float) -> bool:
    """rel_tol=1e-4 against [t/100, t, t*100] — the reference's
    unconditional include_percentage (math_parser.py:521-528)."""
    import math

    return any(
        math.isclose(cand, fg, rel_tol=1e-4)
        for cand in (ft / 100.0, ft, ft * 100.0)
    )


def _split_parts(s: str) -> Optional[List[str]]:
    """Top-level comma split for tuples/sets '(a, b)' / '{a, b}' / 'a, b'."""
    s = _normalize(s)
    wrapped = s[:1] in "({[" and s[-1:] in ")}]"
    inner = s[1:-1] if wrapped else s
    parts, depth, cur = [], 0, []
    for ch in inner:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    if len(parts) < 2:
        return None
    return [p.strip() for p in parts]


def _matrix_rows(s: str) -> Optional[List[List[str]]]:
    s = _normalize(s)
    if not (s.startswith("\\begin{pmatrix}") and s.endswith("\\end{pmatrix}")):
        return None
    body = s[len("\\begin{pmatrix}") : -len("\\end{pmatrix}")]
    return [
        [c.strip() for c in row.split("&")]
        for row in body.split("\\\\") if row.strip()
    ]


def _sympy_equal(a: str, b: str) -> bool:
    try:
        import sympy
        from sympy.parsing.sympy_parser import (
            implicit_multiplication_application,
            parse_expr,
            standard_transformations,
        )

        xa, xb = _latex_to_expr(a), _latex_to_expr(b)
        if _degenerate(xa) or _degenerate(xb):
            return False
        tf = standard_transformations + (implicit_multiplication_application,)
        env = {
            "log10": sympy.Lambda(
                sympy.Symbol("_x"), sympy.log(sympy.Symbol("_x"), 10)
            ),
            "Sum": sympy.Sum, "Integral": sympy.Integral,
            "Abs": sympy.Abs, "binomial": sympy.binomial,
            # latex2sympy maps a bare `e` to Euler's number
            "e": sympy.E,
        }
        ea = parse_expr(xa, transformations=tf, local_dict=env)
        eb = parse_expr(xb, transformations=tf, local_dict=env)
        if ea.has(sympy.Sum, sympy.Integral) or eb.has(
            sympy.Sum, sympy.Integral
        ):
            # NUMERIC-only for Sum/Integral: symbolic simplify/doit — and
            # even Sum.evalf — on a model-controlled summand can run
            # unboundedly (measured: 200 terms of \sin(i^2) stall >140 s).
            # Sums expand by explicit term loop (bounded by the literal-
            # span cap in _latex_to_expr); integrals get quadrature.
            def _num(e):
                for s_ in list(e.atoms(sympy.Sum)):
                    f = s_.function
                    v, lo, hi = s_.limits[0]
                    tot = sum(
                        complex(f.subs(v, i).evalf())
                        for i in range(int(lo), int(hi) + 1)
                    )
                    e = e.subs(s_, sympy.sympify(tot))
                return e.evalf()

            diff = _num(ea) - _num(eb)
            diff = diff.evalf() if hasattr(diff, "evalf") else diff
            return abs(complex(diff)) < 1e-6
        if bool(sympy.simplify(ea - eb) == 0):
            return True
        # numeric fallback: symbolic simplify can miss radical identities
        diff = (ea - eb).evalf()
        return diff.is_number and abs(float(diff)) < 1e-9
    except Exception:  # noqa: BLE001 — unparseable => not equal
        return False


def answers_equal(given: str, truth: str, _depth: int = 0) -> bool:
    ng, nt = _normalize(given), _normalize(truth)
    if ng.lower() == nt.lower() and ng != "":
        return True
    # choice questions: an A-E ground truth cleans the prediction
    if nt in ("A", "B", "C", "D", "E") and _choice_clean(given) == nt:
        return True
    fg, ft = _to_number(given), _to_number(truth)
    if fg is not None and ft is not None:
        if _numeric_candidates_equal(fg, ft):
            return True
    # bracket/brace-insensitive string compare (math_equal:556-569)
    strip_all = str.maketrans("", "", "{}()[]")
    if ng != "" and ng.translate(strip_all).lower() == nt.translate(
        strip_all
    ).lower() and ng.translate(strip_all) != "":
        return True
    if _depth == 0:
        # matrices: elementwise over rows x cols
        mg, mt = _matrix_rows(given), _matrix_rows(truth)
        if mg is not None and mt is not None:
            return (
                len(mg) == len(mt)
                and all(len(rg) == len(rt) for rg, rt in zip(mg, mt))
                and all(
                    answers_equal(g, t, 1)
                    for rg, rt in zip(mg, mt)
                    for g, t in zip(rg, rt)
                )
            )
        # multi-part answers: tuples compare in order, {...} sets any order
        pg, pt = _split_parts(given), _split_parts(truth)
        if pg is not None and pt is not None and len(pg) == len(pt):
            if ng[:1] == "{" and nt[:1] == "{":
                used = set()
                for g in pg:
                    hit = next(
                        (i for i, t in enumerate(pt)
                         if i not in used and answers_equal(g, t, 1)),
                        None,
                    )
                    if hit is None:
                        return False
                    used.add(hit)
                return True
            return all(answers_equal(g, t, 1) for g, t in zip(pg, pt))
        # equations: "2x+1=5" vs "2x=4" — difference up to sign
        if ng.count("=") == 1 and nt.count("=") == 1:
            lg, rg = ng.split("=")
            lt, rt = nt.split("=")
            dg = f"({lg})-({rg})"
            dt = f"({lt})-({rt})"
            if _sympy_equal(dg, dt) or _sympy_equal(f"-({dg})", dt):
                return True
        elif ng.count("=") == 1 and "=" not in nt:
            if answers_equal(ng.split("=")[1], nt, 1):
                return True
        elif nt.count("=") == 1 and "=" not in ng:
            if answers_equal(ng, nt.split("=")[1], 1):
                return True
    return _sympy_equal(given, truth)


def verify_math_solution(generated: str, solutions: List[str]) -> bool:
    """True iff the generated text's final answer matches any ground-truth
    solution (each possibly wrapped in ``\\boxed``).

    Reference parity (``process_results``, math_parser.py:761): the
    generated side gets NO last-number fallback — a solution that never
    commits to an answer scores 0. The ground-truth side extracts from
    ``\\boxed``/"answer is" prose; a solution WITHOUT such a marker is
    tried both whole (bare answers like "(3, 4)" or "x+2" must not be
    reduced to their last digit) and as its last number (the reference's
    use_last_number=True behavior for prose solutions)."""
    ans = extract_answer(generated, use_last_number=False)
    if ans is None or ans.strip() in ("None", "none", ""):
        return False
    for sol in solutions:
        marked = extract_answer(sol, use_last_number=False)
        if marked is not None:
            truths = [marked]
        else:
            truths = [sol]
            nums = _NUM_RE.findall(sol.replace(",", ""))
            if nums and nums[-1] != sol.strip():
                truths.append(nums[-1])
        for truth in truths:
            if truth is None or truth.strip() in ("None", "none", ""):
                continue
            if answers_equal(ans, truth):
                return True
    return False


def grade_math_answers(answers: List[str], solutions: List[str]) -> List[float]:
    """The canonical math reward: +1 / -1 per answer (shared by the sync
    trainer's reward fn and the offline eval harness so training rewards
    and eval scores cannot drift apart)."""
    return [
        1.0 if verify_math_solution(a, solutions) else -1.0 for a in answers
    ]
