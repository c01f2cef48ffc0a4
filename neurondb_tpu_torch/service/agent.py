"""Agent runtime — sessions, memory, tools, execute loop.

Reference: NeuronAgent (Go) — runtime Execute loop (internal/agent/
runtime.go:69-261: load agent+session -> build context -> LLM generate ->
parse tool calls -> execute tools -> persist), vector memory chunks with
embedding search (internal/agent/memory.go), tool registry with
sql/http/code/shell handlers (internal/tools/registry.go:30-33), session
cache + API-key auth (internal/{session,auth}), schema
neurondb_agent.{agents,sessions,messages,memory_chunks,...}
(migrations/001_initial_schema.sql).

Here the store is in-process (optionally JSON-persisted); the LLM is the
gateway router; memory search rides the vector engine. Tool calls use the
same ``{"tool": name, "input": {...}}`` JSON convention; the shell tool
exists for parity but is disabled unless explicitly allowed.

Counterpart of ``neurondb_tpu/service/agent.py`` (no jax there): the same
runtime over the port's ``LLMRouter`` and ``LocalProvider``, whose
``embed`` runs the port's default embedder on ``config.device`` (on the
card, its attention on the flash kernel), so the agent's memory is
embedded there; ``calc`` and ``code`` run the port's own ``safeeval``.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider


# --------------------------------------------------------------------------
# storage records (schema parity)
# --------------------------------------------------------------------------

@dataclass
class Agent:
    agent_id: str
    name: str
    system_prompt: str = ""
    tools: List[str] = field(default_factory=lambda: ["search", "calc"])
    config: Dict = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)


@dataclass
class Session:
    session_id: str
    agent_id: str
    metadata: Dict = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    last_active: float = field(default_factory=time.time)


@dataclass
class Message:
    message_id: str
    session_id: str
    role: str                      # user | assistant | tool
    content: str
    tool_calls: List[Dict] = field(default_factory=list)
    created_at: float = field(default_factory=time.time)


class MemoryStore:
    """Vector memory chunks with embedding search (memory.go parity)."""

    def __init__(self, embed: Callable[[List[str]], np.ndarray]):
        self.embed = embed
        self._texts: Dict[str, List[str]] = {}
        self._vecs: Dict[str, np.ndarray] = {}

    def add(self, agent_id: str, text: str) -> None:
        v = np.asarray(self.embed([text]), np.float32)
        self._texts.setdefault(agent_id, []).append(text)
        cur = self._vecs.get(agent_id)
        self._vecs[agent_id] = v if cur is None else np.vstack([cur, v])

    def search(self, agent_id: str, query: str, k: int = 3) -> List[str]:
        if agent_id not in self._vecs or not len(self._texts[agent_id]):
            return []
        qv = np.asarray(self.embed([query]), np.float32)[0]
        vs = self._vecs[agent_id]
        sims = vs @ qv / (np.linalg.norm(vs, axis=1) *
                          max(np.linalg.norm(qv), 1e-12) + 1e-12)
        order = np.argsort(-sims)[:k]
        return [self._texts[agent_id][i] for i in order]


# --------------------------------------------------------------------------
# tools
# --------------------------------------------------------------------------

class ToolValidator:
    """Per-tool input validation before execution (sandbox/validator
    parity with NeuronAgent internal/tools — required keys, types, and
    size caps are checked before the handler runs)."""

    def __init__(self):
        # name -> {field: (type, required, max_len)}
        self._schemas: Dict[str, Dict[str, tuple]] = {}

    def declare(self, tool: str, **fields) -> None:
        """declare("calc", expression=(str, True, 1000))"""
        self._schemas[tool] = fields

    def validate(self, tool: str, inp: Dict) -> None:
        schema = self._schemas.get(tool)
        if schema is None:
            return
        if not isinstance(inp, dict):
            raise ValueError("tool input must be an object")
        for field_name, (typ, required, max_len) in schema.items():
            if field_name not in inp:
                if required:
                    raise ValueError(f"missing required field "
                                     f"{field_name!r}")
                continue
            val = inp[field_name]
            if not isinstance(val, typ):
                raise ValueError(
                    f"field {field_name!r} must be "
                    f"{getattr(typ, '__name__', typ)}")
            if max_len is not None and isinstance(val, (str, list, dict)) \
                    and len(val) > max_len:
                raise ValueError(f"field {field_name!r} too large "
                                 f"(max {max_len})")


class ToolRegistry:
    """Named tool handlers (NeuronAgent internal/tools/registry.go:30-33
    parity: sql->query, http, code, shell; shell off by default, http off
    unless a fetcher or allowed host list is provided)."""

    def __init__(self, *, allow_shell: bool = False,
                 http_fetcher: Optional[Callable[[str, str, Optional[bytes],
                                                  Dict], tuple]] = None,
                 http_allowed_hosts: Optional[List[str]] = None,
                 http_max_bytes: int = 1 << 20):
        self._tools: Dict[str, Callable[[Dict], str]] = {}
        self.validator = ToolValidator()
        self._http_fetcher = http_fetcher
        self._http_allowed_hosts = http_allowed_hosts
        self._http_max_bytes = int(http_max_bytes)
        self.register("calc", self._calc,
                      expression=(str, True, 1000))
        self.register("echo", lambda inp: str(inp.get("text", "")),
                      text=(str, False, 100_000))
        self.register("code", self._code,
                      code=(str, True, 10_000))
        if http_fetcher is not None or http_allowed_hosts:
            self.register("http", self._http,
                          url=(str, True, 2048), method=(str, False, 8),
                          body=(str, False, 1 << 20), headers=(dict, False,
                                                               64))
        if allow_shell:
            self.register("shell", self._shell,
                          command=(str, True, 10_000))

    def register(self, name: str, fn: Callable[[Dict], str],
                 **schema) -> None:
        self._tools[name] = fn
        if schema:
            self.validator.declare(name, **schema)

    def names(self) -> List[str]:
        return sorted(self._tools)

    def call(self, name: str, inp: Dict) -> str:
        if name not in self._tools:
            return f"error: unknown tool {name!r}"
        try:
            self.validator.validate(name, inp)
            return str(self._tools[name](inp))
        except Exception as e:  # noqa: BLE001
            return f"error: {e}"

    @staticmethod
    def _calc(inp: Dict) -> str:
        """Arithmetic via the sandboxed AST interpreter — bounded pow,
        step budget (no eval; ADVICE r1: '9**9**9**9' must not pin the
        process)."""
        from neurondb_tpu_torch.utils.safeeval import safe_eval
        return str(safe_eval(str(inp.get("expression", ""))))

    @staticmethod
    def _code(inp: Dict) -> str:
        """Restricted mini-program execution (NeuronAgent code tool):
        whitelisted AST nodes only, step/magnitude budgets, no imports,
        no attribute access."""
        from neurondb_tpu_torch.utils.safeeval import safe_exec
        return str(safe_exec(str(inp.get("code", ""))))

    def _http(self, inp: Dict) -> str:
        """HTTP tool: scheme+host allowlist, response size cap. A custom
        fetcher injects transport (tests run with a mock; prod uses
        urllib)."""
        from urllib.parse import urlsplit
        url = str(inp.get("url", ""))
        method = str(inp.get("method", "GET")).upper()
        if method not in ("GET", "POST", "PUT", "DELETE", "HEAD"):
            raise ValueError(f"method {method!r} not allowed")
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError("only http(s) URLs allowed")
        if self._http_allowed_hosts is not None and \
                parts.hostname not in self._http_allowed_hosts:
            raise ValueError(f"host {parts.hostname!r} not in allowlist")
        body = inp.get("body")
        data = body.encode() if isinstance(body, str) else None
        headers = {str(k): str(v)
                   for k, v in (inp.get("headers") or {}).items()}
        if self._http_fetcher is not None:
            status, payload = self._http_fetcher(method, url, data, headers)
            return f"{status}\n{payload[:self._http_max_bytes].decode(errors='replace')}"
        import urllib.request
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        with urllib.request.urlopen(req, timeout=30) as resp:  # noqa: S310
            payload = resp.read(self._http_max_bytes)
            return f"{resp.status}\n{payload.decode(errors='replace')}"

    @staticmethod
    def _shell(inp: Dict) -> str:
        import subprocess
        out = subprocess.run(inp.get("command", "true"), shell=True,
                             capture_output=True, text=True, timeout=30)
        return out.stdout + out.stderr


def _extract_json_objects(text: str) -> List[Dict]:
    """Balanced-brace scan for embedded JSON objects (tool calls can nest
    an "input" object, so a flat regex can't match them)."""
    out: List[Dict] = []
    i = 0
    n = len(text)
    while i < n:
        if text[i] != "{":
            i += 1
            continue
        depth = 0
        for j in range(i, n):
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    frag = text[i:j + 1]
                    try:
                        obj = json.loads(frag)
                        if isinstance(obj, dict):
                            out.append(obj)
                    except json.JSONDecodeError:
                        pass
                    i = j
                    break
        i += 1
    return out


# --------------------------------------------------------------------------
# runtime
# --------------------------------------------------------------------------

class AgentRuntime:
    def __init__(self, router: Optional[LLMRouter] = None,
                 tools: Optional[ToolRegistry] = None,
                 search_fn: Optional[Callable[[str, int], List[str]]] = None,
                 max_tool_rounds: int = 3):
        self.router = router or LLMRouter([LocalProvider()])
        self.tools = tools or ToolRegistry()
        if search_fn is not None:
            handler = lambda inp: "\n".join(  # noqa: E731
                search_fn(str(inp.get("query", "")),
                          int(inp.get("k", 3))))
            # "query" is the engine-backed analog of the reference's sql
            # tool (NeuronAgent internal/tools/registry.go:30) — here the
            # datastore is the vector engine, not PostgreSQL.
            self.tools.register("search", handler,
                                query=(str, True, 10_000))
            self.tools.register("query", handler,
                                query=(str, True, 10_000))
        self.memory = MemoryStore(self.router.embed)
        self.max_tool_rounds = max_tool_rounds
        self.agents: Dict[str, Agent] = {}
        self.sessions: Dict[str, Session] = {}
        self.messages: Dict[str, List[Message]] = {}
        self._lock = threading.Lock()

    # ---- CRUD ----
    def create_agent(self, name: str, system_prompt: str = "",
                     tools: Optional[List[str]] = None,
                     config: Optional[Dict] = None) -> Agent:
        a = Agent(str(uuid.uuid4()), name, system_prompt,
                  tools or ["calc", "echo"], config or {})
        with self._lock:
            self.agents[a.agent_id] = a
        return a

    def create_session(self, agent_id: str,
                       metadata: Optional[Dict] = None) -> Session:
        if agent_id not in self.agents:
            raise KeyError(f"agent {agent_id} not found")
        s = Session(str(uuid.uuid4()), agent_id, metadata or {})
        with self._lock:
            self.sessions[s.session_id] = s
            self.messages[s.session_id] = []
        return s

    def history(self, session_id: str) -> List[Message]:
        return list(self.messages.get(session_id, []))

    # ---- execute loop (runtime.go:69-261) ----
    def execute(self, session_id: str, user_input: str) -> Message:
        sess = self.sessions[session_id]
        agent = self.agents[sess.agent_id]
        sess.last_active = time.time()
        self._append(session_id, "user", user_input)

        mem = self.memory.search(agent.agent_id, user_input)
        prompt = self._build_prompt(agent, session_id, mem)
        content = self.router.complete(prompt)
        tool_calls: List[Dict] = []
        for _ in range(self.max_tool_rounds):
            calls = self._parse_tool_calls(content, agent.tools)
            if not calls:
                break
            for call in calls:
                result = self.tools.call(call["tool"],
                                         call.get("input", {}))
                tool_calls.append({**call, "result": result})
                self._append(session_id, "tool",
                             json.dumps({**call, "result": result}))
            prompt = self._build_prompt(agent, session_id, mem)
            content = self.router.complete(prompt)
        msg = self._append(session_id, "assistant", content, tool_calls)
        self.memory.add(agent.agent_id, f"user: {user_input}\n"
                                        f"assistant: {content}")
        return msg

    def _append(self, session_id: str, role: str, content: str,
                tool_calls: Optional[List[Dict]] = None) -> Message:
        m = Message(str(uuid.uuid4()), session_id, role, content,
                    tool_calls or [])
        self.messages[session_id].append(m)
        return m

    def _build_prompt(self, agent: Agent, session_id: str,
                      memory: List[str]) -> str:
        parts = []
        if agent.system_prompt:
            parts.append(f"[system] {agent.system_prompt}")
        if memory:
            parts.append("[memory]\n" + "\n".join(memory))
        parts.append(f"[tools available] {', '.join(agent.tools)}; call with "
                     '{"tool": "<name>", "input": {...}}')
        for m in self.messages[session_id][-20:]:
            parts.append(f"[{m.role}] {m.content}")
        return "\n".join(parts)

    @staticmethod
    def _parse_tool_calls(content: str, allowed: List[str]) -> List[Dict]:
        return [obj for obj in _extract_json_objects(content)
                if obj.get("tool") in allowed]


# --------------------------------------------------------------------------
# auth (internal/auth parity)
# --------------------------------------------------------------------------

class APIKeyAuth:
    def __init__(self):
        self._keys: Dict[str, str] = {}   # sha256 -> role

    def issue(self, role: str = "user") -> str:
        key = secrets.token_hex(16)
        self._keys[hashlib.sha256(key.encode()).hexdigest()] = role
        return key

    def check(self, key: Optional[str]) -> Optional[str]:
        if not self._keys:
            return "anonymous"           # auth disabled until a key exists
        if key is None:
            return None
        return self._keys.get(hashlib.sha256(key.encode()).hexdigest())
