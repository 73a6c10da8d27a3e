// Native MIDI renderer (midi/fast_render.py): token tensors -> complete
// Standard MIDI File bytes.
//
// Mirrors the Python path (generate.song_from_tokens + midi.writer, with
// midi.song.loop_song for n_loops > 1) byte for byte, including the
// reference's token semantics: stop a cell at EOS/PAD of pitch or duration,
// skip SOS pitches, durations remap [0,95] -> [1,96] clamped to the sequence
// end. Plain C ABI, called through ctypes; no CPython API.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 midirender.cpp -o ...

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int32_t kPitchEOS = 129, kPitchPAD = 130, kPitchSOS = 128;
constexpr int32_t kDurEOS = 97, kDurPAD = 98;

void put_vlq(std::string& out, uint32_t v) {
  uint8_t buf[5];
  int n = 0;
  buf[n++] = v & 0x7F;
  v >>= 7;
  while (v) {
    buf[n++] = 0x80 | (v & 0x7F);
    v >>= 7;
  }
  while (n) out.push_back(static_cast<char>(buf[--n]));
}

void put_u32(std::string& out, uint32_t v) {
  out.push_back(static_cast<char>(v >> 24));
  out.push_back(static_cast<char>(v >> 16));
  out.push_back(static_cast<char>(v >> 8));
  out.push_back(static_cast<char>(v));
}

void put_u16(std::string& out, uint16_t v) {
  out.push_back(static_cast<char>(v >> 8));
  out.push_back(static_cast<char>(v));
}

struct Event {
  int32_t tick;
  int32_t onoff;  // 0 = note-off (sorts first), 1 = note-on
  uint8_t status, pitch, vel;
};

}  // namespace

extern "C" {

// tokens: int32 [n_bars, n_tracks, n_steps, n_slots, 2]
// mask:   uint8 [n_bars, n_tracks, n_steps]
// programs: int32 [n_tracks]; names: concatenated track names, name_lens.
// Returns bytes written into out (capacity cap), or -1 if cap too small.
int64_t poly_render_midi(const int32_t* tokens, const uint8_t* mask,
                         int32_t n_bars, int32_t n_tracks, int32_t n_steps,
                         int32_t n_slots, const int32_t* programs,
                         const uint8_t* names, const int32_t* name_lens,
                         int32_t resolution, int32_t n_loops,
                         int32_t tempo_usec, uint8_t* out, int64_t cap) {
  const int32_t total = n_bars * n_steps;
  const int32_t shift = n_bars * 4 * resolution;
  std::string file;
  file.reserve(1 << 16);

  // header: format 1, 1 meta + n_tracks chunks
  file += "MThd";
  put_u32(file, 6);
  put_u16(file, 1);
  put_u16(file, static_cast<uint16_t>(1 + n_tracks));
  put_u16(file, static_cast<uint16_t>(resolution));

  // meta track: tempo + 4/4 + EOT
  {
    std::string ev;
    put_vlq(ev, 0);
    ev += '\xFF';
    ev += '\x51';
    ev += '\x03';
    ev.push_back(static_cast<char>((tempo_usec >> 16) & 0xFF));
    ev.push_back(static_cast<char>((tempo_usec >> 8) & 0xFF));
    ev.push_back(static_cast<char>(tempo_usec & 0xFF));
    put_vlq(ev, 0);
    const char ts[] = {'\xFF', '\x58', '\x04', 4, 2, 24, 8};
    ev.append(ts, sizeof(ts));
    put_vlq(ev, 0);
    ev += '\xFF';
    ev += '\x2F';
    ev += '\0';
    file += "MTrk";
    put_u32(file, static_cast<uint32_t>(ev.size()));
    file += ev;
  }

  int next_melodic = 0;
  int name_off = 0;
  for (int32_t t = 0; t < n_tracks; ++t) {
    const bool is_drum = (t == 0);
    int ch;
    if (is_drum) {
      ch = 9;
    } else {
      if (next_melodic == 9) ++next_melodic;
      ch = next_melodic++;
    }
    ch &= 0x0F;

    std::string ev;
    const int32_t nlen = name_lens[t];
    if (nlen > 0) {
      put_vlq(ev, 0);
      ev += '\xFF';
      ev += '\x03';
      ev.push_back(static_cast<char>(nlen & 0x7F));
      ev.append(reinterpret_cast<const char*>(names + name_off),
                static_cast<size_t>(std::min(nlen, 127)));
    }
    name_off += nlen;
    int32_t prog = programs[t];
    if (is_drum) prog = 0;
    prog = std::max(0, std::min(prog, 127));
    put_vlq(ev, 0);
    ev.push_back(static_cast<char>(0xC0 | ch));
    ev.push_back(static_cast<char>(prog));

    // base notes for one pass
    struct Note {
      int32_t time, pitch, dur;
    };
    std::vector<Note> notes;
    for (int32_t b = 0; b < n_bars; ++b) {
      for (int32_t s = 0; s < n_steps; ++s) {
        if (!mask[(b * n_tracks + t) * n_steps + s]) continue;
        const int32_t gt = b * n_steps + s;
        const int32_t* cell =
            tokens + ((((b * n_tracks) + t) * n_steps + s) * n_slots) * 2;
        for (int32_t k = 0; k < n_slots; ++k) {
          const int32_t pitch = cell[k * 2];
          const int32_t dur = cell[k * 2 + 1];
          if (pitch == kPitchEOS || pitch == kPitchPAD || dur == kDurEOS ||
              dur == kDurPAD) {
            break;
          }
          if (pitch == kPitchSOS) continue;
          int32_t duration = std::min(dur + 1, total - gt);
          notes.push_back({gt, pitch, duration});
        }
      }
    }

    std::vector<Event> events;
    events.reserve(notes.size() * 2 * static_cast<size_t>(n_loops));
    for (int32_t loop = 0; loop < n_loops; ++loop) {
      const int32_t off = loop * shift;
      for (const Note& n : notes) {
        const uint8_t pitch =
            static_cast<uint8_t>(std::max(0, std::min(n.pitch, 127)));
        const int32_t start = n.time + off;
        events.push_back({start, 1, static_cast<uint8_t>(0x90 | ch), pitch,
                          64});
        events.push_back({start + std::max(n.dur, 1), 0,
                          static_cast<uint8_t>(0x80 | ch), pitch, 0});
      }
    }
    std::stable_sort(events.begin(), events.end(),
                     [](const Event& a, const Event& b) {
                       if (a.tick != b.tick) return a.tick < b.tick;
                       if (a.onoff != b.onoff) return a.onoff < b.onoff;
                       if (a.status != b.status) return a.status < b.status;
                       if (a.pitch != b.pitch) return a.pitch < b.pitch;
                       return a.vel < b.vel;
                     });
    int32_t now = 0;
    for (const Event& e : events) {
      put_vlq(ev, static_cast<uint32_t>(e.tick - now));
      ev.push_back(static_cast<char>(e.status));
      ev.push_back(static_cast<char>(e.pitch));
      ev.push_back(static_cast<char>(e.vel));
      now = e.tick;
    }
    put_vlq(ev, 0);
    ev += '\xFF';
    ev += '\x2F';
    ev += '\0';

    file += "MTrk";
    put_u32(file, static_cast<uint32_t>(ev.size()));
    file += ev;
  }

  if (static_cast<int64_t>(file.size()) > cap) return -1;
  std::memcpy(out, file.data(), file.size());
  return static_cast<int64_t>(file.size());
}

}  // extern "C"
