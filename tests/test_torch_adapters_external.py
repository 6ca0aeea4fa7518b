"""PyTorch port, the external knights: the CLI knights (`claude`, `gemini`,
`codex`), the API knights, `local_llm`, `httpx`, `keys` and the factory's
init-time CLI -> API fallback, against the JAX package's on the same
inputs.

- The CLI knights run stub executables put on PATH that record their
  argv, stdin and environment: both packages must spawn the same
  commands, feed the same prompt, and give the same text or the same
  AdapterError (message and `classify_error` kind).
- The API knights and `local_llm` talk to a loopback `http.server` stub
  through each package's own `httpx.post_json` (the API knights' fixed
  vendor URLs are rewritten to the stub's address, keeping path and
  query): the same request lines, headers and bodies, the same parsed
  text, error kinds and context detection.
- Nothing here reaches an outside host: no vendor CLI but the stubs is on
  PATH, no API key is set but the tests' own, and proxies are off.
"""

import http.server
import importlib
import json
import os
import shutil
import stat
import sys
import threading
import urllib.parse
from pathlib import Path

import pytest

from test_torch_cli import write_config

PACKAGES = ("theroundtaible_tpu", "theroundtaible_tpu_torch")
PORT = PACKAGES[1]
GIT = shutil.which("git")

STUB = """#!{python}
import json, os, sys, time
name = os.path.basename(sys.argv[0])
if sys.argv[1:] == ["--version"]:
    print(name, "1.0")
    sys.exit(int(os.environ.get("STUB_VERSION_RC", "0")))
prompt = sys.stdin.read()
with open(os.environ["STUB_LOG"], "a") as log:
    log.write(json.dumps({{"tool": name, "argv": sys.argv[1:],
                          "stdin": prompt,
                          "claudecode": os.environ.get("CLAUDECODE"),
                          "cwd": os.getcwd()}}) + "\\n")
mode = os.environ.get("STUB_MODE", "ok")
if mode == "sleep":
    time.sleep(30)
if mode == "approval" and "--approval-mode" in sys.argv:
    sys.stderr.write("Unknown arguments: approval-mode\\n")
    sys.exit(1)
sys.stdout.write(os.environ.get("STUB_OUT", ""))
sys.stderr.write(os.environ.get("STUB_ERR", ""))
sys.exit(int(os.environ.get("STUB_RC", "0")))
"""


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def stubs(monkeypatch, tmp_path):
    """PATH: the stub tools and git, nothing else. No API key, a private
    keystore, no proxies."""
    tools = tmp_path / "_path"
    tools.mkdir()
    for name in ("claude", "gemini", "codex"):
        path = tools / name
        path.write_text(STUB.format(python=sys.executable))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tools}{os.pathsep}{Path(GIT).parent}")
    for var in ("ANTHROPIC_API_KEY", "GEMINI_API_KEY", "OPENAI_API_KEY",
                "CLAUDECODE", "http_proxy", "https_proxy", "HTTP_PROXY",
                "HTTPS_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setenv("ROUNDTABLE_KEYS_DIR", str(tmp_path / "_keys"))
    monkeypatch.setenv("STUB_LOG", str(tmp_path / "stub.log"))
    return tools


def outcome(call):
    """A call's text, or its error as (class, kind, message)."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, getattr(e, "kind", None), str(e))


def stub_log(tmp_path) -> list:
    log = tmp_path / "stub.log"
    lines = log.read_text().splitlines() if log.exists() else []
    log.unlink(missing_ok=True)
    return [json.loads(line) for line in lines]


# --- the CLI knights ---

JSONL = "\n".join([
    "warming up",
    json.dumps({"type": "item.started", "item": {"type": "agent_message"}}),
    json.dumps({"type": "item.completed",
                "item": {"type": "agent_message", "text": "First part."}}),
    "{not json",
    json.dumps({"type": "item.completed",
                "item": {"type": "reasoning", "text": "hidden"}}),
    json.dumps({"type": "item.completed",
                "item": {"type": "agent_message", "text": "Second."}})])

CLI_CASES = {
    # name: (adapter class, constructor args, env, timeout_ms, cwd in git)
    "claude_ok": ("ClaudeCliAdapter", (), {"STUB_OUT": "I agree.",
                                           "CLAUDECODE": "1"}, 10_000, True),
    "claude_auth": ("ClaudeCliAdapter", (), {
        "STUB_RC": "1", "STUB_ERR": "Error: 401 Unauthorized"}, 10_000,
        True),
    "claude_overloaded": ("ClaudeCliAdapter", (), {
        "STUB_RC": "1", "STUB_ERR": "529 overloaded"}, 10_000, True),
    "claude_empty_failure": ("ClaudeCliAdapter", (), {"STUB_RC": "3"},
                             10_000, True),
    "claude_timeout": ("ClaudeCliAdapter", (), {"STUB_MODE": "sleep"}, 1_000,
                       True),
    "claude_not_installed": ("ClaudeCliAdapter", ("no-such-claude",), {},
                             10_000, True),
    "gemini_ok": ("GeminiCliAdapter", (), {"STUB_OUT": "Plan text."},
                  10_000, True),
    "gemini_model": ("GeminiCliAdapter", ("gemini", "gemini-2.5-flash"),
                     {"STUB_OUT": "Fast."}, 10_000, True),
    "gemini_plan_mode_retry": ("GeminiCliAdapter", (), {
        "STUB_MODE": "approval", "STUB_OUT": "Answered without plan."},
        10_000, True),
    "gemini_long_output_nonzero": ("GeminiCliAdapter", (), {
        "STUB_RC": "2", "STUB_OUT": "x" * 60}, 10_000, True),
    "gemini_failure": ("GeminiCliAdapter", (), {
        "STUB_RC": "2", "STUB_OUT": "short", "STUB_ERR": "rate limit"},
        10_000, True),
    "codex_ok": ("OpenAICliAdapter", (), {"STUB_OUT": JSONL}, 10_000, True),
    "codex_outside_git": ("OpenAICliAdapter", (), {"STUB_OUT": JSONL},
                          10_000, False),
    "codex_no_message": ("OpenAICliAdapter", (), {"STUB_OUT": "just logs"},
                         10_000, True),
    "codex_failure": ("OpenAICliAdapter", (), {
        "STUB_RC": "1", "STUB_ERR": "command not found: node"}, 10_000,
        True),
}


@pytest.mark.parametrize("name", CLI_CASES)
def test_cli_knight_spawns_and_parses_as_jax(name, tmp_path, monkeypatch):
    cls, args, env, timeout_ms, in_git = CLI_CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cwd = tmp_path / ("repo" if in_git else "plain")
    cwd.mkdir()
    if in_git:
        import subprocess
        subprocess.run([GIT, "init", "-q"], cwd=cwd, check=True,
                       capture_output=True, timeout=60)
    monkeypatch.chdir(cwd)
    prompt = "Round 1. What do you think?\n" + "é" * 3
    out = {}
    for pkg in PACKAGES:
        adapter = getattr(mod(pkg, "adapters.cli_adapters"), cls)(*args)
        out[pkg] = (adapter.name, outcome(
            lambda: adapter.execute(prompt, timeout_ms)), stub_log(tmp_path))
    assert out[PORT] == out[PACKAGES[0]]
    _, result, calls = out[PORT]
    if name.endswith("_ok"):
        assert isinstance(result, str) and calls[0]["stdin"] == prompt
    if name == "claude_ok":
        assert calls[0]["claudecode"] is None
        assert calls[0]["argv"][:2] == ["--print", "--output-format"]
    if name == "claude_auth":
        assert result[:2] == ("AdapterError", "auth")
    if name == "claude_timeout":
        assert result[:2] == ("AdapterError", "timeout")
    if name == "claude_not_installed":
        assert result[:2] == ("AdapterError", "not_installed")
    if name == "gemini_plan_mode_retry":
        assert [("--approval-mode" in c["argv"]) for c in calls] == [True,
                                                                      False]
    if name == "codex_ok":
        assert result == "First part.\nSecond."
        assert "--skip-git-repo-check" not in calls[0]["argv"]
    if name == "codex_outside_git":
        assert "--skip-git-repo-check" in calls[0]["argv"]
    if name == "codex_no_message":
        assert result[:2] == ("AdapterError", "api")


@pytest.mark.parametrize("version_rc", ["0", "1"])
def test_cli_knights_probe_availability_as_jax(version_rc, monkeypatch):
    monkeypatch.setenv("STUB_VERSION_RC", version_rc)
    for cls in ("ClaudeCliAdapter", "GeminiCliAdapter", "OpenAICliAdapter"):
        found = [getattr(mod(pkg, "adapters.cli_adapters"), cls)()
                 .is_available() for pkg in PACKAGES]
        assert found == [version_rc == "0"] * 2
    assert not mod(PORT, "adapters.cli_adapters").ClaudeCliAdapter(
        "no-such-tool").is_available()


def test_codex_event_parser_equals_jax():
    for text in (JSONL, "", "{}", '{"type": "item.completed"}'):
        assert [mod(pkg, "adapters.cli_adapters").OpenAICliAdapter
                .extract_agent_message(text) for pkg in PACKAGES] == \
            [mod(PACKAGES[0], "adapters.cli_adapters").OpenAICliAdapter
             .extract_agent_message(text)] * 2


# --- the loopback HTTP stub ---

class Stub:
    """A loopback HTTP server answering scripted responses per path (the
    last one repeats) and recording every request."""

    def __init__(self):
        self.responses: dict[str, list] = {}
        self.requests: list = []
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _answer(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else ""
                headers = {k.lower(): v for k, v in self.headers.items()
                           if k.lower() != "host"}
                stub.requests.append((self.command, self.path, headers,
                                      json.loads(body) if body else None))
                queue = stub.responses.get(urllib.parse.urlsplit(
                    self.path).path, [(404, {"error": "no route"})])
                status, payload = queue.pop(0) if len(queue) > 1 \
                    else queue[0]
                data = (payload if isinstance(payload, str)
                        else json.dumps(payload)).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _answer

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def script(self, responses: dict) -> None:
        self.responses = {k: list(v) for k, v in responses.items()}
        self.requests = []

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def stub():
    s = Stub()
    yield s
    s.close()


def route_api_to(stub, monkeypatch, pkg) -> list:
    """`pkg`'s API knights post through its own httpx.post_json to the
    stub: the vendor URL's scheme and host become the stub's. Returns
    the list of vendor URLs asked for."""
    api = mod(pkg, "adapters.api_adapters")
    real = mod(pkg, "adapters.httpx").post_json
    asked = []

    def post(url, payload, headers=None, timeout_s=120.0):
        asked.append(url)
        parts = urllib.parse.urlsplit(url)
        local = stub.url + parts.path + (f"?{parts.query}" if parts.query
                                         else "")
        return real(local, payload, headers=headers, timeout_s=timeout_s)
    monkeypatch.setattr(api, "post_json", post)
    return asked


ANTHROPIC = "/v1/messages"
GEMINI = "/v1beta/models/gemini-2.5-flash:generateContent"
OPENAI = "/v1/chat/completions"
API_CASES = {
    # name: (class, env key, responses by path)
    "claude_ok": ("ClaudeApiAdapter", "ANTHROPIC_API_KEY", {ANTHROPIC: [
        (200, {"content": [{"type": "thinking"},
                           {"type": "text", "text": "Claude says."}]})]}),
    "claude_empty": ("ClaudeApiAdapter", "ANTHROPIC_API_KEY", {ANTHROPIC: [
        (200, {"content": [{"type": "text", "text": ""}]})]}),
    "claude_unauthorized": ("ClaudeApiAdapter", "ANTHROPIC_API_KEY", {
        ANTHROPIC: [(401, {"error": "invalid x-api-key"})]}),
    "claude_overloaded": ("ClaudeApiAdapter", "ANTHROPIC_API_KEY", {
        ANTHROPIC: [(529, "overloaded")]}),
    "gemini_ok": ("GeminiApiAdapter", "GEMINI_API_KEY", {GEMINI: [
        (200, {"candidates": [{"content": {"parts": [
            {"text": "Gemini says."}]}}]})]}),
    "gemini_malformed": ("GeminiApiAdapter", "GEMINI_API_KEY", {GEMINI: [
        (200, {"candidates": []})]}),
    "gemini_rate_limited": ("GeminiApiAdapter", "GEMINI_API_KEY", {GEMINI: [
        (429, {"error": {"message": "rate limit"}})]}),
    "openai_ok": ("OpenAIApiAdapter", "OPENAI_API_KEY", {OPENAI: [
        (200, {"choices": [{"message": {"content": "GPT says."}}]})]}),
    "openai_server_error": ("OpenAIApiAdapter", "OPENAI_API_KEY", {OPENAI: [
        (500, "internal")]}),
    "openai_null": ("OpenAIApiAdapter", "OPENAI_API_KEY", {OPENAI: [
        (200, {"choices": [{"message": {"content": None}}]})]}),
    "claude_no_key": ("ClaudeApiAdapter", None, {ANTHROPIC: [(200, {})]}),
}


def jax_kind_without_url(responses) -> "str | None":
    """The kind JAX's classify_error gives a case's HttpError without its
    URL. The port classifies an HttpError by its status and body alone;
    JAX also sniffs the URL, so a stub port holding "401" or "403" made a
    500 "auth" there (ROADMAP Queue 3, F4). None for a 2xx case."""
    (status, payload), = [r[0] for r in responses.values()]
    if status < 400:
        return None
    body = payload if isinstance(payload, str) else json.dumps(payload)
    errors = mod(PACKAGES[0], "core.errors")
    return errors.classify_error(
        mod(PACKAGES[0], "adapters.httpx").HttpError(status, body, ""))


@pytest.mark.parametrize("name", API_CASES)
def test_api_knight_requests_and_parses_as_jax(name, stub, monkeypatch):
    cls, env_key, responses = API_CASES[name]
    if env_key:
        monkeypatch.setenv(env_key, "test-key-123")
    out = {}
    for pkg in PACKAGES:
        asked = route_api_to(stub, monkeypatch, pkg)
        stub.script(responses)
        adapter = getattr(mod(pkg, "adapters.api_adapters"), cls)()
        result = outcome(lambda: adapter.execute("Hello there", 5_000))
        out[pkg] = (adapter.is_available(), result, asked,
                    list(stub.requests))
    jax_out = out[PACKAGES[0]]
    kind = jax_kind_without_url(responses)
    if kind is not None and isinstance(jax_out[1], tuple) and \
            jax_out[1][0] == "AdapterError" and stub.requests:
        jax_out = (jax_out[0], (jax_out[1][0], kind, jax_out[1][2]),
                   *jax_out[2:])
    assert out[PORT] == jax_out
    available, result, asked, requests = out[PORT]
    assert available == bool(env_key)
    if name.endswith("_ok"):
        assert result.endswith("says.")
        (method, path, headers, body) = requests[0]
        assert method == "POST" and headers["content-type"] == \
            "application/json"
        assert json.dumps(body).count("Hello there") == 1
    if name == "claude_ok":
        assert asked == ["https://api.anthropic.com/v1/messages"]
        assert requests[0][2]["x-api-key"] == "test-key-123"
        assert requests[0][3]["max_tokens"] == 16384
    if name == "gemini_ok":
        assert asked[0].endswith(":generateContent?key=test-key-123")
    if name in ("claude_unauthorized",):
        assert result[:2] == ("AdapterError", "auth")
    if name in ("claude_overloaded", "gemini_rate_limited",
                "openai_server_error", "claude_empty", "gemini_malformed",
                "openai_null"):
        assert result[:2] == ("AdapterError", "api")
    if name == "claude_no_key":
        assert result[:2] == ("AdapterError", "auth") and requests == []


@pytest.mark.parametrize("status,body,kind", [
    (500, "internal", "api"), (529, "overloaded", "api"),
    (429, "slow down", "api"), (401, "invalid x-api-key", "auth"),
    (403, "forbidden", "auth")])
def test_http_error_classified_without_its_url(status, body, kind):
    """F4: an HttpError classifies by its status and body, never by its
    URL - a loopback port or custom baseUrl holding "401" or "403" leaves
    a 500 "api" (JAX's classify_error reads the URL too, and says "auth"
    for the first three here)."""
    from theroundtaible_tpu_torch.adapters.httpx import HttpError
    from theroundtaible_tpu_torch.core.errors import classify_error
    url = "http://127.0.0.1:40123/v1/chat/completions?key=4031"
    assert classify_error(HttpError(status, body, url)) == kind
    assert classify_error(HttpError(status, body, "")) == kind
    jerr = mod(PACKAGES[0], "core.errors")
    jhttp = mod(PACKAGES[0], "adapters.httpx")
    assert jerr.classify_error(jhttp.HttpError(status, body, "")) == kind
    assert jerr.classify_error(jhttp.HttpError(status, body, url)) == "auth"


def test_httpx_equals_jax(stub):
    stub.script({"/p": [(200, {"ok": 1})], "/bad": [(418, "teapot")],
                 "/v1/models": [(200, {"data": []})]})
    out = {}
    for pkg in PACKAGES:
        httpx = mod(pkg, "adapters.httpx")
        stub.requests = []
        got = [outcome(lambda: httpx.post_json(
                   stub.url + "/p", {"a": [1, "é"]}, headers={"X-T": "1"})),
               outcome(lambda: httpx.post_json(stub.url + "/bad", {})),
               httpx.get_ok(stub.url + "/v1/models"),
               httpx.get_ok(stub.url + "/missing"),
               httpx.get_ok("http://127.0.0.1:9/v1/models", timeout_s=1)]
        out[pkg] = (got, list(stub.requests))
    assert out[PORT] == out[PACKAGES[0]]
    got, requests = out[PORT]
    assert got[0] == {"ok": 1} and got[1][0] == "HttpError"
    assert got[2:] == [True, False, False]
    assert requests[0][2]["x-t"] == "1"


# --- local_llm ---

LOCAL_CASES = {
    # name: (source, responses by path, prompt length)
    "ollama": ("Ollama", {
        "/api/show": [(200, {"model_info": {
            "general.name": "q", "qwen2.context_length": 8192}})],
        "/api/chat": [(200, {"message": {"content": "Ollama says."}})],
        "/v1/models": [(200, {"data": []})]}, 40),
    "ollama_clamped": ("Ollama", {
        "/api/show": [(200, {"model_info": {"llama.context_length": 4096}})],
        "/api/chat": [(200, {"message": {"content": "ok"}})]}, 4000),
    "ollama_no_context": ("Ollama", {
        "/api/show": [(500, "boom")],
        "/api/chat": [(200, {"message": {}})]}, 40),
    "ollama_reloaded": ("Ollama", {
        "/api/show": [(200, {})],
        "/api/chat": [(500, "Model reloaded"),
                      (200, {"message": {"content": "after reload"}})]}, 40),
    "lm_studio": ("LM Studio", {
        "/v1/chat/completions": [(200, {"choices": [{"message": {
            "content": "LM says."}}]})]}, 40),
    "lm_studio_context": ("LM Studio", {
        "/v1/chat/completions": [(400, {"error": "n_keep: 5000 >= n_ctx: "
                                                 "4096"})]}, 20000),
    "openai_compat_auth": (None, {
        "/v1/chat/completions": [(403, "forbidden")]}, 40),
    "down": (None, {}, 40),
}


@pytest.mark.parametrize("name", LOCAL_CASES)
def test_local_llm_requests_and_parses_as_jax(name, stub, monkeypatch):
    source, responses, n = LOCAL_CASES[name]
    prompt = "p" * n
    out = {}
    for pkg in PACKAGES:
        local = mod(pkg, "adapters.local_llm")
        monkeypatch.setattr(local.time, "sleep", lambda s: None)
        stub.script(responses)
        endpoint = stub.url + "/" if name != "down" else \
            "http://127.0.0.1:9"
        adapter = local.LocalLlmAdapter(endpoint, "qwen2.5:7b", "Qwen",
                                        source=source, timeout_ms=5_000)
        mod(pkg, "adapters.factory")._post_init(adapter)
        out[pkg] = (adapter.endpoint == endpoint.rstrip("/"),
                    adapter.detected_context_tokens,
                    adapter.get_max_source_chars(), adapter.is_available(),
                    outcome(lambda: adapter.execute(prompt)),
                    list(stub.requests))
    assert out[PORT] == out[PACKAGES[0]]
    _, ctx, chars, _, result, requests = out[PORT]
    if name == "ollama":
        assert ctx == 8192 and chars == 2000 * 4   # the 2000-token floor
        chat = [r for r in requests if r[1] == "/api/chat"][0][3]
        assert chat["options"]["num_ctx"] == 10 + 4096 + 512
        assert result == "Ollama says."
    if name == "ollama_clamped":
        chat = [r for r in requests if r[1] == "/api/chat"][0][3]
        assert chat["options"]["num_ctx"] == 4096 and chars == 2000 * 4
    if name == "ollama_reloaded":
        assert result == "after reload"
    if name == "lm_studio":
        assert chars == (16384 - 4096 - 3000) * 4
        (chat,) = [r[3] for r in requests if r[1] == OPENAI]
        assert "max_tokens" not in chat
    if name == "lm_studio_context":
        assert result[1] == "api" and "Context Length" in result[2]
    if name == "openai_compat_auth":
        assert result[:2] == ("AdapterError", "auth")
    if name == "down":   # a refused connection carries no marker
        assert result[:2] == ("AdapterError", "unknown")


# --- the factory ---

FACTORY_CASES = {
    # name: (knights, adapter_config, env, tools removed from PATH)
    "cli_seated": ([("Claude", "claude-cli"), ("GPT", "openai-cli")],
                   {"claude-cli": {"command": "claude"}}, {}, ()),
    "cli_to_api_fallback": ([("Claude", "claude-cli"),
                             ("Gemini", "gemini-cli")],
                            {"claude-api": {"model": "claude-x"}},
                            {"ANTHROPIC_API_KEY": "k"}, ("claude", "gemini")),
    "unavailable": ([("GPT", "openai-cli"), ("Local", "local-llm")],
                    {"local-llm": {"model": "m"}}, {}, ("codex",)),
    "api_from_keystore": ([("GPT", "openai-api")],
                          {"openai-api": {"env_key": "MY_OPENAI"}}, {}, ()),
    "local_ollama": ([("Qwen", "local-llm-qwen")], {"local-llm-qwen": {
        "endpoint": "<stub>", "model": "qwen", "name": "Qwen",
        "source": "Ollama"}}, {}, ()),
}


@pytest.mark.parametrize("name", FACTORY_CASES)
def test_factory_seats_external_knights_as_jax(name, tmp_path, stub, stubs,
                                               monkeypatch):
    knights, adapter_config, env, removed = FACTORY_CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for tool in removed:
        (stubs / tool).unlink()
    if name == "api_from_keystore":
        mod(PORT, "utils.keys").save_key("MY_OPENAI", "from-store")
    cfg_json = json.loads(json.dumps(adapter_config).replace(
        "<stub>", stub.url))
    stub.script({"/api/show": [(200, {"model_info": {
        "qwen2.context_length": 32768}})], "/v1/models": [(200, {})]})
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        write_config(root, knights=[
            {"name": n, "adapter": a, "capabilities": [], "priority": i + 1}
            for i, (n, a) in enumerate(knights)], adapter_config=cfg_json)
        config = mod(pkg, "core.config").load_config(root)
        events = []
        kwargs = {"device": "cpu"} if pkg == PORT else {}
        adapters = mod(pkg, "adapters.factory").initialize_adapters(
            config, lambda kind, msg: events.append((kind, msg)), **kwargs)
        out[pkg] = (events, {a: (type(ad).__name__, ad.name,
                                 vars(ad).get("model"),
                                 vars(ad).get("env_key"),
                                 vars(ad).get("detected_context_tokens"))
                             for a, ad in adapters.items()})
    assert out[PORT] == out[PACKAGES[0]]
    events, seated = out[PORT]
    kinds = [k for k, _ in events]
    if name == "cli_seated":
        assert seated["claude-cli"][0] == "ClaudeCliAdapter"
        assert kinds == ["seated", "seated"]
    if name == "cli_to_api_fallback":
        assert seated == {"claude-cli": ("ClaudeApiAdapter", "Claude",
                                         "claude-x", "ANTHROPIC_API_KEY",
                                         None)}
        assert kinds == ["fallback", "unavailable"]
    if name == "unavailable":
        assert seated == {} and kinds == ["unavailable"] * 2
    if name == "api_from_keystore":
        assert seated["openai-api"][0] == "OpenAIApiAdapter"
    if name == "local_ollama":
        assert seated["local-llm-qwen"][4] == 32768


# --- keys ---

def test_keys_equal_jax(tmp_path, monkeypatch):
    out = {}
    for pkg in PACKAGES:
        keys = mod(pkg, "utils.keys")
        home = tmp_path / pkg / "store"
        monkeypatch.setenv("ROUNDTABLE_KEYS_DIR", str(home))
        before = (keys.load_keys(), keys.get_key("K1"))
        keys.save_key("K1", "one")
        keys.save_key("K2", "two")
        monkeypatch.setenv("K2", "from-env")
        after = (keys.load_keys(), keys.get_key("K1"), keys.get_key("K2"),
                 keys.get_key("K3"))
        monkeypatch.delenv("K2")
        modes = (stat.S_IMODE(keys.keys_file().stat().st_mode),
                 stat.S_IMODE(keys.keys_dir().stat().st_mode))
        text = keys.keys_file().read_text()
        keys.keys_file().write_text("{broken")
        out[pkg] = (before, after, modes, text, keys.load_keys())
    assert out[PORT] == out[PACKAGES[0]]
    before, after, modes, _, broken = out[PORT]
    assert before == ({}, None)
    assert after == ({"K1": "one", "K2": "two"}, "one", "from-env", None)
    assert modes == (0o600, 0o700) and broken == {}
