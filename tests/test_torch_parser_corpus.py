"""The port's netlist and Verilog-A front ends against the JAX package's
over the in-repo corpora (``tests/data/ref_corpus``, ``binning``,
``sv-tests``, the BSIM-CMG 107 sources) and the dialect cases of
``tests/test_parser_dialects.py``: both parse every file to the same
statements (their ``repr``, which names every field), fail on the same
files with the same message, lex and preprocess to the same tokens, and
render the same diagnostics.  The port's parser, lexer, preprocessor and
Spectre grammar are copies; these tests hold them to the JAX package's
behaviour on real inputs as ``test_torch_package.py`` holds their text.

``tests/data/va_errors`` holds the renderer's goldens of the reference's
error corpus, whose ``.va`` inputs are not in the repo; the diagnostics
here are rendered from synthetic inputs of the same kinds (a missing
``;``, an undefined macro inside an expansion, recursion, a missing
parenthesis), byte for byte between the packages, with the goldens'
phrases.
"""

import glob
import os

import pytest

from cedarsim_tpu.frontend import elaborate as jel
from cedarsim_tpu.frontend import parser as jparser
from cedarsim_tpu.frontend import spectre as jspectre
from cedarsim_tpu.va import lexer as jlexer
from cedarsim_tpu.va import parser as jvaparser
from cedarsim_tpu.va import preproc as jpreproc
from cedarsim_tpu_torch.frontend import elaborate as tel
from cedarsim_tpu_torch.frontend import parser as tparser
from cedarsim_tpu_torch.frontend import spectre as tspectre
from cedarsim_tpu_torch.models import BSIMCMG107_DIR
from cedarsim_tpu_torch.va import lexer as tlexer
from cedarsim_tpu_torch.va import parser as tvaparser
from cedarsim_tpu_torch.va import preproc as tpreproc

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NETLISTS = sorted(
    glob.glob(os.path.join(DATA, "ref_corpus", "*.cir"))
    + glob.glob(os.path.join(DATA, "ref_corpus", "*.s[cp]*"))
    + glob.glob(os.path.join(DATA, "ref_corpus", "*.spice"))
    + glob.glob(os.path.join(DATA, "binning", "*.cir")))
#: the reference's blacklist of SystemVerilog-only files (sv_tests.jl)
SV_BLACKLIST = {"number_test_2.sv", "number_test_3.sv", "preproc_test_2.svh"}
SV_FILES = sorted(
    p for sub in ("number", "preproc")
    for p in glob.glob(os.path.join(DATA, "sv-tests", sub, "*.sv*"))
    if os.path.basename(p) not in SV_BLACKLIST)
CMG_SOURCES = sorted(f for f in os.listdir(BSIMCMG107_DIR)
                     if f.endswith((".va", ".include")))


def _outcome(fn):
    try:
        return "ok", repr(fn())
    except Exception as e:        # the same failure, by type and message
        return type(e).__name__, str(e)


@pytest.mark.parametrize("path", NETLISTS, ids=os.path.basename)
def test_corpus_netlist_parses_as_in_the_jax_package(path):
    with open(path, errors="replace") as f:
        text = f.read()
    start = "spectre" if path.endswith(".scs") else "spice"
    got = _outcome(lambda: tspectre.parse_mixed(
        text, file=path, start_lang=start).statements)
    assert got == _outcome(lambda: jspectre.parse_mixed(
        text, file=path, start_lang=start).statements)
    broken = os.path.basename(path) in ("errors.cir", "errors.scs")
    assert (got[0] != "ok") == broken


#: ``test_parser_dialects.py``'s cases: (netlist, dialect, elaborate too)
DIALECTS = {
    "ngspice_n_is_osdi": ("t\nN1 d g s b mybsim W=1u L=1u\n.end\n",
                          "ngspice", False),
    "hspice_s_is_sparam": ("t\nS1 in out smod zo=50\n.end\n", "hspice",
                           False),
    "ngspice_s_stays_switch": ("t\nS1 a b c d smod\n.end\n", None, False),
    "xyce_y_is_osdi": ("t\nY1 a b mymod\n.end\n", "xyce", False),
    "osdi_elaboration_redirects_to_va": ("t\nN1 d g s b mybsim\n.end\n",
                                         "ngspice", True),
    "sparam_needs_model_card": ("t\nS1 in out smod\n.end\n", "hspice",
                                True),
}


@pytest.mark.parametrize("case", sorted(DIALECTS))
def test_dialect_letters_as_in_the_jax_package(case):
    text, dialect, elab = DIALECTS[case]
    kw = {} if dialect is None else {"spice_dialect": dialect}
    tnl = tparser.parse_spice(text, **kw)
    jnl = jparser.parse_spice(text, **kw)
    assert repr(tnl.statements) == repr(jnl.statements)
    el = [s for s in tnl.statements if getattr(s, "letter", None)][0]
    assert el.letter == {"ngspice_s_stays_switch": "s",
                         "hspice_s_is_sparam": "sparam",
                         "sparam_needs_model_card": "sparam"}.get(
        case, "osdi")
    if elab:
        with pytest.raises(tel.ElabError) as te:
            tel.elaborate(tnl)
        with pytest.raises(jel.ElabError) as je:
            jel.elaborate(jnl)
        # the same location and reason; the port's OSDI message names its
        # own VA pipeline where the JAX package's names "VA→JAX"
        t, j = str(te.value), str(je.value)
        assert t.split(": ")[0] == j.split(": ")[0]
        assert ("Verilog-A source" in t) == ("Verilog-A source" in j) \
            == (case == "osdi_elaboration_redirects_to_va")
        if case == "sparam_needs_model_card":
            assert t == j


@pytest.mark.parametrize("path", SV_FILES, ids=os.path.basename)
def test_sv_corpus_parses_as_in_the_jax_package(path):
    with open(path) as f:
        text = f.read()
    inc = [os.path.dirname(path)]
    got = _outcome(lambda: tvaparser.parse_va(text, file=path,
                                              include_paths=inc))
    assert got[0] == "ok"
    assert got == _outcome(lambda: jvaparser.parse_va(
        text, file=path, include_paths=inc))


@pytest.mark.parametrize("src", [
    "32'd42", "32'hFF", "8'b1010", "8'o17", "'h0", "32'Sh7", "32 'd 7",
    "32'h7f_ff", "1_000_000", "1'bx", "32'dz"])
def test_based_literals_lex_as_in_the_jax_package(src):
    assert repr(tlexer.lex_va(src)) == repr(jlexer.lex_va(src))


@pytest.mark.parametrize("name", CMG_SOURCES)
def test_cmg_source_tokens_as_in_the_jax_package(name):
    """Each BSIM-CMG 107 source lexes to the same raw tokens (kind, text,
    value, file, line, column) in both packages; the top file
    preprocesses to the same token stream with the same origin chains."""
    path = os.path.join(BSIMCMG107_DIR, name)
    with open(path, errors="replace") as f:
        text = f.read()
    assert repr(tlexer.lex_va(text, path)) == repr(jlexer.lex_va(text, path))
    if name == "bsimcmg.va":
        args = (text, path)
        kw = dict(include_paths=(BSIMCMG107_DIR,))
        assert repr(tpreproc.preprocess(*args, **kw)) == \
            repr(jpreproc.preprocess(*args, **kw))


BROKEN_VA = {
    "missing_semi": ("module m(p, n);\n  inout p, n;\n  electrical p, n;\n"
                     "  analog begin\n    V(p, n) <+ 1.0\n  end\n"
                     "endmodule\n", "expected ';'"),
    "undef_in_expansion": ("`define M(x) (x + `NOPE)\n"
                           "module m(p); electrical p;\n"
                           "analog V(p) <+ `M(2.0); endmodule\n",
                           "in expansion of `M"),
    "recursive_macro": ("`define A `B(`A)\n`define B(x) (x)\n"
                        "module m(p); electrical p; analog V(p) <+ `A;"
                        " endmodule\n", "recursive expansion of macro"),
    "if_missing_paren": ("module m(p); electrical p;\n"
                         "analog begin if (1 > 0 V(p) <+ 1; end\n"
                         "endmodule\n", "error"),
}


@pytest.mark.parametrize("case", sorted(BROKEN_VA))
def test_va_diagnostics_render_as_in_the_jax_package(case):
    text, phrase = BROKEN_VA[case]
    out = []
    for parser, preproc in ((tvaparser, tpreproc), (jvaparser, jpreproc)):
        with pytest.raises((parser.VAParseError,
                            preproc.VAPreprocError)) as ei:
            parser.parse_va(text, f"{case}.va")
        out.append(ei.value.render())
    assert out[0] == out[1]
    assert phrase in out[0]
