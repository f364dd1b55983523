// Reference TX-throughput benchmark (TEST TOOLING, not part of the
// framework).  Times the *reference* LoRaMod block's 9-state FSM
// (/root/reference/LoRaMod.cpp) producing chirp samples for a queue of
// symbol packets, single-threaded, built -O3.  Companion to
// bench_reference.cpp (RX side); see BASELINE.md.
//
// Prints one JSON line: {"samples", "seconds", "msps", "packets"}.
//
// Usage: bench_reference_mod <symbols.u16> <sf> <sync> <ampl> <reps>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "LoRaMod.cpp"  // the reference block (-I /root/reference)

int main(int argc, char **argv)
{
    if (argc != 6)
    {
        fprintf(stderr,
                "usage: %s <symbols.u16> <sf> <sync> <ampl> <reps>\n",
                argv[0]);
        return 2;
    }
    const size_t sf = strtoul(argv[2], nullptr, 0);
    const unsigned sync = unsigned(strtoul(argv[3], nullptr, 0));
    const float ampl = float(atof(argv[4]));
    const size_t reps = strtoul(argv[5], nullptr, 0);

    FILE *f = fopen(argv[1], "rb");
    if (f == nullptr) return 2;
    std::vector<uint16_t> syms;
    uint16_t s16 = 0;
    while (fread(&s16, sizeof(s16), 1, f) == 1) syms.push_back(s16);
    fclose(f);

    LoRaMod *blk = static_cast<LoRaMod *>(LoRaMod::make(sf));
    blk->setSync((unsigned char)sync);
    blk->setOvs(1);
    blk->setPadding(1);
    blk->setAmplitude(ampl);
    blk->activate();

    for (size_t r = 0; r < reps; r++)
    {
        Pothos::Packet pkt;
        pkt.payload = Pothos::BufferChunk(typeid(uint16_t), syms.size());
        memcpy(pkt.payload.as<uint16_t *>(), syms.data(),
               syms.size() * sizeof(uint16_t));
        blk->input(0)->pushMessage(Pothos::Object(pkt));
    }

    auto *out = blk->output(size_t(0));
    size_t produced = 0;
    size_t idle = 0;
    const auto t0 = std::chrono::steady_clock::now();
    // the FSM produces one symbol-duration per work(); it returns without
    // producing on each message pop (1 idle call, then production resumes)
    // and forever once the queue drains — stop on 3 consecutive idles
    for (size_t iter = 0; iter < (1u << 26) && idle < 3; iter++)
    {
        blk->work();
        const size_t now = out->totalElements();
        if (now == produced) { idle++; continue; }
        idle = 0;
        produced = now;
    }
    const auto t1 = std::chrono::steady_clock::now();
    const double sec = std::chrono::duration<double>(t1 - t0).count();

    printf("{\"samples\": %zu, \"seconds\": %.4f, \"msps\": %.3f, "
           "\"packets\": %zu}\n",
           produced, sec, produced / sec / 1e6, reps);
    return 0;
}
