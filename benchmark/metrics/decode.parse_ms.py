"""decode.parse_ms: host clock around the benchmark's own `read_model`
calls on the pool's files (entropy decode and dequantization), mean ms."""


def read(m):
    v = m.get("parse_ms")
    if not v:
        return None
    return sum(v) / len(v)
