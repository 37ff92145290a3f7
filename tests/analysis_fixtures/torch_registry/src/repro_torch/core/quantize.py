def quant_variants(pq_m: int = 16) -> dict:
    return {
        "full": dict(kind="none"),
        "pq8": dict(kind="pq", pq_m=pq_m),
    }


IVF_QUANT_KINDS = ("pq",)
